"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Phases, each printing one line of its own numbers; any failure exits
non-zero:

  1. device   — requires a CUDA card; prints nvidia-smi's name and power
                limit; turns TF32 off for fp32 matrix products and cuDNN.
  2. build    — compiles every CUDA kernel from ``src/repro_torch/kernels/
                csrc/`` (one nvcc per source, started together).
  3. kernels  — holds each kernel (paged decode attention, the
                expert-parallel path's moe_gemm, fused_topk_route and
                histogram_offsets, Griffin's rg_lru_scan, and the backward
                kernels of the router, the scan and moe_gemm) against its
                plain PyTorch version on the card at the main paths'
                full-width shapes, and times the kernel, the plain version,
                a library call that computes the same function where one
                exists (a yardstick only; the port never calls it) and the
                least time the card could take (bound). Paged attention
                (a split pass and a combine pass per call) also runs one
                slot alone and all slots at length 1023, and prints its
                split plan and the pair's device time under torch.profiler.
                moe_gemm also runs the rows and counts of one real routed
                decode step (decode_live) and the decode shape on a replica
                store's 16-row tensors (decode_store: 12 slots, 12 distinct
                rows, against the 12-set bound), and prints its device time
                and the time of reading every slot's weights and every
                named expert's once at the memory rate. The two launch-bound
                kernels, fused_topk_route and histogram_offsets, print
                their device time, their time after the kernel that
                precedes each on the main path, and an untimed sweep over
                the shapes where their designs change (every case held to
                the same checks); an empty kernel gives the card's launch
                floor beside them. (moe_gemm's correction-round case runs
                in phase t2e, its rescue-round cases in phase resched, each
                on a real round's rows.) Phases router_bwd and rg_lru_bwd
                hold the training path's backward kernels against their
                plain versions: fused_topk_route_bwd at the router's shapes
                and the train step's (1 x 2048 x 8, K 2, tie rows; and at
                E 16 / K 4, E 128 / K 1 and K 2, E 64 / K 6) plus an untimed sweep over
                T, R, E <= 256, K and every subset of the gradients (a
                missing one is a null pointer); rg_lru_scan_bwd
                at the train step's 2 x 1024 x 2560 and the prefill's 8 x
                3072 x 2560, then ragged shapes and each gradient alone, bit
                for bit. Both scan phases also run, untimed and bit for bit,
                shapes at the edges of the kernels' ring of time tiles
                (S ragged below and past the whole ring, D ragged by the
                64-channel strip with D % 4 == 0 and not, fewer and more
                strips than 2 x 132, rows not 16-byte aligned); phase
                rg_lru times the forward at the train shape too, with its
                device time. Each is timed by events, by the profiler, its plain
                version and (router) the autograd chain through softmax,
                gather and logsumexp; phase train adds each on a real step's
                layer-0 inputs. Phase moe_gemm_bwd holds moe_gemm's
                backward against its plain version at the EP train step's
                layer (8 slots x 4 x 160 rows with the packer's counts, d
                4096, F 14336, bf16), the serving layout (12 slots naming 8
                experts), garbage in the dead rows, gelu and relu at d 1024
                / F 2048 and fp32 there, each timed by events and the
                profiler beside its plain version and the autograd chain
                through the weights' gather and bmm; and the train layer at
                llama-moe-3.5b's (swiglu, F 688), switch-base-128's (relu,
                d 768, F 3072) and deepseek-v2-lite-16b's (swiglu, d 2048,
                F 1408, 64 slots) widths. Each of its cases also prints the
                device time of each launch by kernel name (rows, pack, dh,
                hidden, input, weight_gu, weight_down) beside that part's
                own bound; the kernels line's row carries the train case's
                split as "parts". With --src another commit's src/, the
                same phase times that commit's design on the same card. The paper's other MoE models' shapes
                run in the forward phases too: paged attention at G 1 (hd
                128, 32 KV heads; hd 64, 12 KV heads) and G 7; moe_gemm's
                decode and prefill blocks at llama-moe's, switch's and
                deepseek's (d 2048, F 1408, 68 slots) widths; the router at
                E 16 / K 4, E 128 / K 1 and K 2, E 64 / K 6; the histogram
                at the packer's 6, 18, 21, 34, 69 and 133 classes and at
                128.
  4. main     — Mixtral-8x7B at published widths with random weights from
                ``--seed``, through ``repro_torch.serve.ContinuousEngine``
                (dist_only, 4 EP ranks, one replica slot per rank): first
                the dense MoE path over the first 2 layers, then the
                expert-parallel path (``ep=True``) over 8 of the 32 layers
                at the engine's defaults: the replica store
                (``replica_impl="store"``), layer-staged migration on a side
                stream, ``prefetch_lead`` 2 and the migration gate. Both on
                one set of weights, each serving the same trace; checks
                completions, tokens, kernel launch counts (reset before and
                read after each run), that a re-plan replicated an expert
                and, under EP, that a replica slot computed pairs, that a
                migration committed with bytes moved and that every live
                replica row equals its expert's home row; prints the
                migration counters, the modelled stall (the reference's
                A100-PCIe link, not this card) and the store's bytes. Then:
                a mid-migration check (some layers of a staged fill ready:
                one EP decode forward through the store equals, bit for
                bit, the ``replica_impl="gather"`` forward under the mixed
                plan); EP decode steps profiled with torch.profiler, with
                the store and with a ``"gather"`` engine on the same
                weights and plan (device time by kernel, idle share; each
                EP kernel's time and launches per step); and the decode
                steps during which a fill is in flight (the copies' device
                time per entry and rate, each stream's busy time).
                Then RecurrentGemma-2B at published widths, all 26 layers,
                through ``repro_torch.launch.serve.main`` (``ServeEngine``):
                16 requests of 3072 prompt tokens in batches of 8, 64 new
                tokens each; checks completions and that every recurrent
                layer of every prefill launched rg_lru_scan, reads prefill
                and decode step times from the run's trace, and profiles
                decode steps on the same weights.
  5. gps      — (run between phase 4's Mixtral and Griffin runs) the
                GPS decision loop on the main path's Mixtral weights
                (8 of 32 layers): ``ContinuousEngine(ep=True)`` at the
                store defaults with an ``OnlineGPSController`` on the
                ``H100_SXM_NVLINK`` preset (a window of 8 iterations,
                patience 1) replays ``workloads.skew_shift_trace`` (221
                bursty requests whose topic mix goes flat -> concentrated
                -> flat) through ``run_trace(time_scale=20)``, kernel
                counts set to 0 just before and read just after. Checks
                completions and tokens, launches, one decision per closed
                window, the engine's strategy and ``predict_interval``
                after each decision (under "none": no fill in flight, the
                identity plan), every audit record replayed through
                ``recommend_strategy``, a hot-middle window skew above the
                flat start's, a switch to "none" and one back, live replica
                rows equal to their home rows, and a fill restarted in
                flight (two forwards bit-equal to the gather forward under
                their mixed plans, the new target on the device). Prints
                the windows' skews, verdicts and intervals, the audit
                summary, the migration counters with fills restarted or
                cancelled in flight, the modelled stall on the preset
                beside the A100-PCIe figure for the same bytes, step and
                TTFT p50, decode tokens/s, imbalance, drops, peak memory
                and the controller's host time per evaluation.
  6. t2e      — (run after gps, before Griffin) Token-to-Expert prediction
                on the same Mixtral weights: fits the predictor ladder
                (global and per-token frequency models; the FFN and LSTM
                predictors trained on the card with AdamW) on a synthetic
                routing trace (256 x 64 tokens, vocab 32000, 8 layers,
                skew 1.8, 80/20 split) and prints each rung's held-out
                accuracy, FLOPs per token, fit time and predict time per
                1 x 512 prompt (host wall and CUDA events), holding the FFN
                and LSTM forwards on the card against the CPU; serves the
                main trace on the EP store engine under
                ``strategy="token_to_expert"`` with the conditional model
                and with the LSTM (each prefill layer a predicted dispatch
                round and a correction round: two moe_gemm and two
                histogram_offsets launches, counted against the same
                formula), printing the mispredicted share and the serving
                numbers beside phase 4's dist_only run; holds a real
                correction round's moe_gemm inputs (12 slots x 4 ranks x
                cap2 8 rows, its live counts) against the plain version
                (the kernels line's ``prefill_correction`` case, with its
                time, device time and bound); and replays
                ``skew_shift_trace(horizon=45)`` with an
                ``OnlineGPSController(predictor_available=True)`` on the
                A100-PCIe preset (the JAX default), checking launches, the
                engine following each decision, every audit record
                replayed, and a switch into token_to_expert and one out.
  7. resched  — (run after t2e, before Griffin) token rescheduling on the
                same Mixtral weights: the JAX package's lever A/B
                (``bench_serve_traces.py``: capacity factor 0.5, 10
                prompts of 40-60 copies of token 7; legs duplicate,
                reschedule with the greedy scheduler, both with the LP),
                checking completions, launches and that the rescheduling
                legs planned quotas, overflowed and paid rescue a2a bytes;
                the main trace under ``lever="reschedule"`` and ``"both"``
                (each EP layer of each forward a rescue round: one more
                moe_gemm and histogram_offsets, and one more
                histogram_offsets per decode layer for the global
                positions, counted against the same formula) beside phase
                4's dist_only run; the busiest kept rescue rounds'
                moe_gemm inputs held against the plain version (the
                kernels line's ``prefill_rescue`` and ``decode_rescue``
                cases); the host milliseconds per quota re-plan, greedy
                against LP, at 8 and 32 layers; and
                ``skew_shift_trace(horizon=45)`` under a controller
                offered all three levers (H100 preset), checking launches,
                the engine following each decision's strategy and lever,
                and every audit record replayed.
  8. serve_ep — (run after resched, before Griffin) ``ServeEngine(ep=True)``
                on the same Mixtral weights: 3 batches of 8 x 512 Zipf
                prompts (``data.synthetic.token_batches(--seed)``), 24 new
                tokens each, 4 ranks, one replica slot, a re-plan per batch,
                in eight legs: the store with staged fills, synchronous
                fills, ``replica_impl="gather"``, the first two again at
                capacity factor 12 (``capacity()`` then covers every pair),
                in-graph planning, lever "reschedule" (greedy) and "both"
                (LP). Per leg: prefill ms per batch, decode step p50 and
                tokens/s (host clock between synchronisations), dropped and
                overflowed pairs, window skew, measured rank imbalance,
                migration entries, bytes and steps to adopt, peak memory,
                and launches (counts set to 0 before and read after each
                leg) against the formula (no paged attention: the linear
                cache). Checks: sync and gather ids equal, the no-drop
                legs drop nothing and their ids are equal, the in-graph
                plans equal ``duplicate_experts_device`` run on the CPU on
                the same counts (its CUDA-event time beside the host
                planner's, one call under ``torch.cuda.
                set_sync_debug_mode("error")``), and under a lever every
                forward from the first re-plan on carries a quota; and
                the last prefill's kernel inputs in the store legs at
                capacity factor 1.25 and 12 (layer 0's router logits, its
                first round's packer ids, expert rows and counts) held
                against the plain versions (the kernels line's
                ``serve_ep_store`` / ``serve_ep_store_nodrop`` cases).
  9. reference — reduced models' logits on the card against the CPU path:
                Mixtral dense and EP, and Griffin with prompts longer than
                its local window.
 10. roofline — (host only, after the Mixtral phases) ``repro_torch.
                roofline``'s analytic report of Mixtral-8x7B (one replica
                slot per rank, as the EP engine runs it) at 8 and 32 layers
                for the main trace's decode step (8 sequences, 1024
                positions) and a 512-token prefill, on the H100's data
                sheet figures; beside it phase 4's EP decode step p50 as a
                share of the card's peak for the step's model FLOPs, and
                the roofline's memory time beside the step's profiled
                device busy time.
 11. profile  — ``ContinuousEngine.profile_phases`` on an EP store engine
                (4 ranks, one replica slot, the main trace's config) over
                the first 2 Mixtral layers at full width (a fresh model
                from ``--seed``: ``init_model`` draws the embedding and
                head, then the layers in order, so these are the main
                path's first 2 layers): the prefill bucket (512 tokens),
                then ``metrics.reset_phases()`` and a decode-shaped profile
                (8 tokens). Prints seconds per phase (attn, route, pack,
                a2a, ffn, combine, total, migrate, prefetch); checks every
                phase > 0, ``total`` the sum of the five dispatch phases,
                the ``phase_*_us`` columns, the spans on the
                "dispatch-profile" track and each phase's kernel launches
                (route: fused_topk_route, pack: histogram_offsets, ffn:
                moe_gemm, attn: paged_decode_attention). Also the packers
                (sort against onehot) and paged attention (fused against
                gather) head to head, the ffn phase beside phase 3's
                moe_gemm rows, and the phases' sum over 8 layers beside
                phase 4's profiled EP decode step.
 12. fleet    — the JAX package's fleet A/B (``bench_serve_traces.py``)
                at full width: two Mixtral instances sharing one 4-layer
                model (a fresh model from ``--seed``, the main path's first
                4 layers), ``FleetEngine(ep=True)`` with 4 ranks and 2
                replica slots each, ``workloads.build_workload(
                "fleet_shift")`` (47 requests: a chat tenant ramping onto a
                hot topic beside a flat batch tenant) on a virtual clock
                (0.25 s per fleet step, at most 320); a static leg and an
                arbiter leg. Checks for both: drained, every request
                completed with its tokens, launches against phase 4's
                formula summed over the two engines, the ledger's quotas
                summing to what was provisioned, no allocator above its
                quota, the merged trace valid with one pid per model; the
                arbiter leg moved quota at least once, the static leg
                never. Prints attainment (all and worst tenant), moves,
                final quotas, fleet step p50 / p99 and peak memory.

 13. models   — (after reference, before train; alone with ``--phases
                models``) the paper's other MoE models at published widths,
                random weights from ``--seed``: llama-moe-3.5b (all 32
                layers; 16 experts, top-4, MHA, F 688), switch-base-128 (all
                12 layers; 128 experts, top-1, relu, MHA, d 768) and
                arctic-480b (2 of 35 layers: 27.2 GB a layer; 128 experts,
                top-2, G 7, the dense residual branch), each through
                ``ContinuousEngine`` (8 slots, bucket 128, 8 requests of
                32..128 tokens, 16 new each) on the dense path, then the EP
                path (4 ranks, one replica slot, the store) under dist_only
                and under none; per run the card, step p50, decode tokens/s,
                peak memory, measured and modelled imbalance, drops and the
                four serving kernels' exact launches; the dist_only run's
                first prefill's layer-0 router, histogram and moe_gemm
                inputs against their plain versions (``models_<arch>``);
                Algorithm 1's host and in-graph times at E 128; then 10
                train steps of 4 x 512 for llama-moe and switch at 2
                layers, dense and EP (4 ranks), with exact launches. Arctic
                trains on the CPU parity tests only (218 GB of fp32 state a
                layer); the phase prints why.
 14. dense    — (after models, before train; alone with ``--phases dense``)
                the dense family at published widths and every layer,
                random weights from ``--seed`` (qwen's QKV biases drawn
                nonzero): qwen1.5-0.5b (24 layers, QKV bias), olmo-1b (16,
                the non-parametric LayerNorm), stablelm-3b (32, head_dim
                80) and minicpm-2b (40, 36 KV heads, tied embeddings, WSD).
                Each through ``ContinuousEngine`` on phase 4's trace
                (completions, tokens, exact launches: paged attention once
                a layer a decode step, nothing else), step p50, TTFT p50,
                decode tokens/s, peak memory, and profiled decode steps
                (the device's idle share); qwen and minicpm also through
                ``repro_torch.launch.serve.main`` (one batch of 8 x 512, 64
                new tokens, exit 0); then 10 train steps of 4 x 512 Zipf
                tokens at the launcher's schedule (stablelm and minicpm
                with ``remat``; minicpm through
                ``repro_torch.launch.train.main``, its WSD lr checked step
                by step), step ms, tokens/s, peak memory, the model-FLOPs
                share, a repeated batch whose loss must fall and the step's
                breakdown; last, each reduced config (stablelm also at
                head_dim 80) card against CPU for a prefill and a decode
                step. The four geometries' paged attention cases run in
                phase 3 (``PAGED_MODEL_CASES``).
 15. mla      — (after dense, before train; alone with ``--phases mla``)
                deepseek-v2-lite-16b at published widths and all 27 layers
                (MLA attention over a 576-value latent cache a position and
                layer, 64 experts top-6 beside 2 shared ones), random
                weights from ``--seed``, through ``ServeEngine``: one batch of
                8 x 512 Zipf prompts, 64 new tokens, on the dense MoE path
                and on the EP path (4 ranks, one replica slot, the store)
                under dist_only and under none; per run prefill ms, decode
                step p50, decode tokens/s, peak memory, measured and
                modelled imbalance, drops and the exact launches of the
                router, histogram and moe_gemm (no paged attention: the
                latent cache is linear); the dist_only run's prefill's
                layer-0 kernel inputs against their plain versions
                (``mla_<model>``) and the idle share of its profiled decode
                steps. Then ``repro_torch.launch.serve --data-mesh 1
                --model-mesh 4`` (one batch, exit 0, exact launches); 10
                train steps of 4 x 512 at 4 of 27 layers (44.1 GB of fp32
                state; 2 layers if 4 runs out of memory), dense and EP, with
                step ms, tokens/s, peak memory, the model-FLOPs share and
                exact launches, a real step's layer-0 backward inputs
                against the plain versions (``mla_train``) and a repeated
                batch whose loss must fall; last, the reduced config and
                its scale (q/k 96 wide over head_dim 64) and router (E 16,
                K 6, 2 shared) variants card against CPU, dense and EP.
 16. rwkv     — (after mla, before train; alone with ``--phases rwkv``)
                rwkv6-7b at published widths and all 32 layers (the
                attention-free RWKV-6 time mix and relu^2 channel mix,
                7.618e9 parameters held, 15.24 GB in bf16), random weights
                from ``--seed``, through ``ServeEngine`` (strategy none):
                one batch of 8 x 512 Zipf prompts, 64 new tokens; prefill
                ms, decode step p50, decode tokens/s, peak memory, finite
                logits, every request's tokens, no kernel launched
                (``ops.LAUNCHES`` all zero: the port's RWKV is plain
                PyTorch, as the JAX package's is plain ``jnp``); a profiled
                prefill (busy time, idle share, the WKV's device and host
                shares from a profiler range around ``wkv_chunked``) and
                two profiled decode steps (busy, idle share, device
                operations). Then ``repro_torch.launch.serve --arch
                rwkv6-7b`` (8 requests of 512, 16 new tokens); 10 train
                steps of 4 x 512 at 8 of 32 layers (36.9 GB of fp32 state;
                6 or 4 if 8 runs out of memory) with step ms, tokens/s,
                peak memory, the model-FLOPs share, a repeated batch whose
                loss must fall and the forward-and-backward against AdamW
                split; the reduced config and its ``clip`` and ``shift``
                weight variants card against CPU (a prefill of 2 x 75, two
                decode steps: logits within 5e-2 x their largest, the WKV
                state within 1e-3 in norm at layer 0 and 1e-2 over all
                layers); last ``wkv_chunked`` against a
                ``wkv_step`` loop on one full-width layer (8 x 512, 64
                heads of 64, fp32) with and without the clip, within
                1e-4 in norm.
 17. seamless — (after rwkv, before train; alone with ``--phases
                seamless``) seamless-m4t-medium at published widths and
                all 12 + 12 layers (the encoder-decoder: a bidirectional
                frame encoder under a GQA decoder with cross-attention,
                877.1e6 parameters held, 1.754 GB in bf16), random weights
                from ``--seed``, through ``ServeEngine`` (strategy none):
                8 requests of 1024 random frames (~20 s of speech at 50
                frames/s) and a 64-token Zipf prompt, 64 new tokens, then
                one batch of 8 x 4096 frames (``max_source_len``), 8 new
                tokens; prefill ms, decode step p50, decode tokens/s, peak
                memory, finite logits, every request's tokens, no kernel
                launched (``ops.LAUNCHES`` all zero); for each, a profiled
                prefill (busy time, idle share, the encoder's device and
                host shares from a profiler range around ``_encode``) and
                two profiled decode steps (busy, idle share, device
                operations, the cross-attention's share from a range around
                ``cross_decode``). Then ``repro_torch.launch.train --arch
                seamless-m4t-medium`` (10 steps of 4 x 512 over the JAX
                launcher's zero frames), held to the JAX launcher's
                behaviour there: a finite step-0 loss, a NaN gradient norm
                (the encoder's RMSNorms at 0 scale the gradient by 1000
                each, and 12 layers overflow it) and exit 1; 10 train steps
                of 4 x 512 tokens over 4 x 1024 random frames at all layers
                (14.0 GB of fp32 state) with step ms, tokens/s, peak
                memory, the model-FLOPs share, the encoder's and the
                cross-attention's gradient norms (nonzero), a repeated
                batch whose loss must fall and the forward-and-backward
                against AdamW split; last the reduced config and its
                ``long`` (600 frames) and ``g1`` (G 1, the encoder at 8
                heads of 32) variants card against CPU (the encoder's
                output and the cross cache within 1e-2 and 2e-2 in norm,
                logits within 5e-2 x their largest).
 18. llava    — (after seamless, before train; alone with ``--phases
                llava``) llava-next-34b at published widths and all 60
                layers (the VLM backbone: 2880 patch embeddings before the
                tokens; 34.39e9 parameters, 68.78 GB in bf16), random
                weights from ``--seed``, after every earlier engine is
                freed. Through ``ServeEngine`` (strategy none): 2 requests
                of 2880 random prefix embeddings (0.02 x a normal) and a
                64-token Zipf prompt, a prefill and 32 decode steps at the
                true positions P + S + t (prefill ms, decode step p50 and
                tokens/s, peak memory, finite logits, no kernel launched),
                a prefill with CUDA events around each
                ``chunked_attention`` call (its device share), the same
                prefill under the profiler's device tracing (busy, idle
                share) and two profiled decode steps, then ``generate``'s 8 tokens at the reference's
                positions S + t. Through ``ContinuousEngine`` text only on
                the same weights: 8 x 64 tokens, 32 new
                (``paged_decode_attention`` exactly once a layer a decode
                step), its decode steps profiled, the kernel at that pool
                shape (8 slots, G 7, hd 128, M 6) against its plain
                version, the library call, "gather" and its bound (the
                kernels line's ``cases``), and the trace again under
                ``paged_attn_impl="gather"``: no launch, the same tokens or
                a first difference at a near tie. Then 10 train steps at 4
                of 60 layers under ``remat`` (50.4 GB of fp32 state) over 2
                x (2880 random prefix + 512 tokens), the model-FLOPs share
                by the JAX formula and with the prefix counted, a repeated
                batch whose loss must fall, and one step on the launcher's
                zero prefix (finite at this depth, as the JAX step's in the
                CPU test); last the reduced config and its "wide" variant
                (G 7, head_dim 128, 600 prefix embeddings) card against CPU.
 19. sweep    — (after llava, before train; alone with ``--phases
                sweep``) the port's sweep harness (``repro_torch.sweep``)
                as users call it, after every earlier engine is freed.
                ``python -m repro_torch.sweep run --smoke --mesh 1x4
                --workload skew_shift --strategy dist_only --device cuda``
                (the smoke spec's reduced Mixtral) with its report,
                history, per-job traces and merged trace under
                ``chiprun_out/sweep/``: exit 0, the job ok on this card,
                the merged trace valid. Then llama-moe-3.5b at published
                widths and all 32 layers (6.74e9 parameters), random
                weights from ``--seed``, mesh 1x4 under every strategy
                value (dist_only, token_to_expert, reschedule, both) at
                the smoke engine shape and trace, ``max_iters`` 400: the
                dist_only point in this process through ``run_point``,
                kernel counts set to 0 just before and read just after and
                held to its engine's warmup (one prefill, one decode),
                prefills and decode steps; the other three through
                ``run_sweep``, one subprocess each, which load the kernels
                this script built. Every document must be ok, drained, on
                device cuda with this card's name; per point the step p50
                / p99, TTFT p50 (virtual clock), decode tokens/s,
                completions, dropped and overflowed pairs, migration
                re-plans and bytes and rescue plans. Last ``collect`` over
                the four documents into a fresh history, ``report`` over it
                (one row per series) and the spec's k8s manifests (every
                one valid, none applied).
 20. train    — (last, after every serving engine is freed) training on
                the card. Mixtral-8x7B at published widths cut to 2 of 32
                layers (fp32 weights, gradients and two moments: 16 bytes a
                parameter, 50.6 GB; 3 layers would need 73.9 GB before
                activations), ``make_train_step`` on the single-device MoE
                path: 10 steps of 4 x 512 Zipf tokens (``token_batches
                (--seed)``) at the launcher's schedule; per step loss, aux
                loss, grad norm, lr, window skew and step ms, then tokens/s,
                peak memory, the model-FLOPs share of peak and the router's
                forward and backward launches (2 each a step); at fixed
                weights one batch through the plain step, ``remat`` and 2
                microbatches (losses held together); one batch repeated at a
                fixed lr, whose loss must fall. The same model through the
                expert-parallel dispatch (4 EP ranks, the identity plan, cf
                1.25): 10 steps with dropped pairs per step, exact launches
                of moe_gemm, moe_gemm_bwd, histogram_offsets and the router
                and its backward (one each a layer and step), the breakdown
                with moe_gemm_bwd's share, and one batch of a fresh model
                EP against dense at a capacity factor where nothing drops.
                RecurrentGemma-2B at all 26
                layers through ``repro_torch.launch.train.main`` (10 steps of
                2 x 1024, return code 0, 18 scans and 18 scan backwards a
                step). Each run's layer-0 backward inputs of one step are held
                against the plain version (the kernels line's ``train_step``
                cases). Then reduced Mixtral (single-device and EP) and
                Griffin, one step on the card against the CPU from the same
                bridged weights.

The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``. The kernels JSON lists the three backward
kernels beside the five forward ones, with ``gradient_of`` naming the
forward kernel and their launches from phase train. Run from the repository root:

    python3 chip_smoke.py [--seed N] [--phases router,histogram,...] [--src DIR]

``--phases`` runs a subset (no kernels JSON then); ``--src`` runs the
``repro_torch`` under another commit's ``src/`` (for example one unpacked
with ``git archive`` into ``build/``), its kernels built from its own
sources, so that two versions are measured in one run on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM, dense bf16 tensor cores
MAIN_LAYERS = 8                    # of Mixtral's 32: 32 bf16 layers ~93 GB > 80 GB
DENSE_LAYERS = 2                   # the dense path's run: all experts on all tokens
EP_RANKS, DUP_SLOTS = 4, 1
EP_KERNELS = ("moe_gemm", "histogram_offsets")   # the router runs on both paths
GRIFFIN_ARGS = dict(requests=16, batch=8, seq=3072, new_tokens=64)
MEASURED = {}                      # numbers one phase measures for another


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text: str):
    """(function, line) for each register and stack line of an nvcc
    ``-Xptxas=-v`` log, the function demangled where ``c++filt`` exists
    and cut to its name and template arguments."""
    out, function = [], "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
            try:
                function = subprocess.run(
                    ["c++filt", function], capture_output=True, text=True,
                    timeout=10).stdout.strip() or function
            except (OSError, subprocess.SubprocessError):
                pass
            function = function.replace("(anonymous namespace)::", "")
            function = function.split("(")[0].removeprefix("void ")
        elif "registers" in line or "bytes stack" in line:
            out.append((function, line.strip()))
    return out


def time_ms(fn, flush: torch.Tensor, runs: int = 25) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn``, the L2 cache flushed
    (a write of ``flush``, 256 MiB unless a phase says otherwise) before
    each run, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: paged decode attention against its plain version
# ---------------------------------------------------------------------------

PAGED_KERNELS = ("split_kernel", "combine_kernel")   # the pair one call launches


# the other models' decode shapes, no window (label: KV heads, query heads
# per KV head, head dim): llama-moe-3.5b and switch-base-128 are MHA (G 1),
# arctic-480b 56 query heads over 8 KV heads (G 7); the dense family is MHA
# too: qwen1.5-0.5b, olmo-1b (hd 128), stablelm-3b (hd 80: ten 16-byte
# chunks a bf16 row, twenty in fp32) and minicpm-2b (36 KV heads)
PAGED_MODEL_CASES = {"llama_moe_g1": (32, 1, 128), "switch_g1_hd64": (12, 1, 64),
                     "arctic_g7": (8, 7, 128),
                     "qwen_g1_hd64": (16, 1, 64), "olmo_g1_hd128": (16, 1, 128),
                     "stablelm_g1_hd80": (32, 1, 80),
                     "minicpm_g1_k36": (36, 1, 64)}


def _paged_case(q, kp, vp, tab, lengths, lens, window, flush, timed: bool):
    """One ``paged_decode_attention`` call held against the plain version
    and the kernel's own two passes in plain PyTorch (same split plan); the
    bound from the live K / V rows; with ``timed`` (bf16) also the kernel's
    events and profiler time, the plain version's and the library call's
    (gather the view, expand KV heads, one fused attention)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import smem_bytes, split_plan

    b, K, G, hd = q.shape
    bs, M = kp.shape[1], tab.shape[1]
    dtype, elem = q.dtype, q.element_size()
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
    splits, P = split_plan(b, K, M, bs, hd, elem, G)

    def library(q, kp, vp, tables, lengths, window):
        kv = [ref.gather_view(p, tables).permute(0, 2, 1, 3)
              .repeat_interleave(G, dim=1) for p in (kp, vp)]
        S = kv[0].shape[2]
        pos = torch.arange(S, device=q.device)[None, :]
        cl = (lengths + 1)[:, None]
        mask = pos < cl
        if window > 0:
            mask &= pos >= cl - window
        out = torch.nn.functional.scaled_dot_product_attention(
            q.reshape(b, K * G, 1, hd), kv[0], kv[1],
            attn_mask=mask[:, None, None, :])
        return out.reshape(b, K, G, hd)

    got = ops.paged_decode_attention(q, kp, vp, tab, lengths, window=window)
    want = ref.paged_decode_plain(q, kp, vp, tab, lengths, window=window)
    want_split = ref.paged_decode_split_plain(q, kp, vp, tab, lengths,
                                              window=window,
                                              blocks_per_split=P)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    err_split = (got.float() - want_split.float()).abs()
    atol, rtol = tol[dtype]
    ok = bool((err <= atol + rtol * want.float().abs()).all()
              and (err_split <= atol + rtol * want_split.float().abs()).all()
              and torch.isfinite(got.float()).all())
    cl = np.asarray(lens) + 1
    live = (np.minimum(cl, window) if window > 0 else cl).sum()
    m_lo = np.where((window > 0) & (cl > window), (cl - window) // bs, 0)
    m_hi = np.minimum(-(-cl // bs) - 1, M - 1)
    live_ctas = K * int(sum(hi // P - lo // P + 1
                            for lo, hi in zip(m_lo, m_hi)))
    nbytes = (live * K * hd * 2 * elem      # live K and V rows
              + 2 * q.numel() * elem        # q in, out
              + lengths.numel() * 4
              + sum(-(-int(c) // bs) for c in cl) * 4)
    flops = live * K * G * hd * 4           # QK^T and PV
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    row = {"max_abs_err": float(err.max()),
           "max_abs_err_split": float(err_split.max()), "ok": ok,
           "bound_ms": bound_ms,
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / FP32_FLOPS else "operations"),
           "splits": splits, "blocks_per_split": P,
           "ctas": splits * K * b, "live_ctas": live_ctas,
           "smem_bytes": smem_bytes(P, bs, hd, G, elem)}
    if timed:
        args = (q, kp, vp, tab, lengths)
        row["ms"] = time_ms(lambda: ops.paged_decode_attention(
            *args, window=window), flush)
        row["plain_ms"] = time_ms(lambda: ref.paged_decode_plain(
            *args, window=window), flush)
        row["library_ms"] = time_ms(lambda: library(*args, window), flush)
        row["profiler_ms"] = device_ms(lambda: ops.paged_decode_attention(
            *args, window=window), flush)
    return row


def paged_attention_phase(flush: torch.Tensor, seed: int, path_window: int):
    """The phase's shape (B 8, K 8, G 4, hd 128, bs 16, M 64 from max_len
    1024) at lengths 0..1023 in fp32 and bf16 under three windows, then two
    more bf16-timed cases: one slot alone at length 1023 (B = 1) and all 8
    slots at 1023. Then the other models' decode shapes
    (``PAGED_MODEL_CASES``: G 1 at hd 128, 80 and 64 over 12 to 36 KV
    heads, G 7) at the same lengths with no window, fp32 and bf16 (bf16
    timed). Prints each case's split
    plan, and the profiler's device time of the kernel pair for the path
    row (bf16, ``path_window``)."""
    B, K, G, hd, bs, M = 8, 8, 4, 128, 16, 64
    N = 1 + B * M                                        # block 0 = null
    lengths_l = [0, 15, 16, 200, 511, 777, 1000, 1023]   # 0, block edges, ~1023
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    perm = torch.randperm(B * M, generator=gen, device=dev).to(torch.int32)
    tables = (1 + perm).reshape(B, M).contiguous()
    shapes = {"": (K, G, hd)}
    shapes.update(PAGED_MODEL_CASES)
    # (label, shape key, slots, lengths, windows): the first is the path's case
    cases = [("path", "", B, lengths_l, (0, 18, path_window)),
             ("one_slot_1023", "", 1, [1023], (path_window,)),
             ("all_1023", "", B, [1023] * B, (path_window,))]
    cases += [(label, label, B, lengths_l, (0,)) for label in PAGED_MODEL_CASES]
    results, bases = {}, {}
    for label, key, b, lens, windows in cases:
        k_, g_, hd_ = shapes[key]
        if key not in bases:
            bases = {key: {n: torch.randn(shape, generator=gen, device=dev)
                           for n, shape in (("q", (B, k_, g_, hd_)),
                                            ("k", (N, bs, k_, hd_)),
                                            ("v", (N, bs, k_, hd_)))}}
        base = bases[key]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        tab = tables[:b].contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            q = base["q"][:b].to(dtype).contiguous()
            kp, vp = (base[n].to(dtype) for n in ("k", "v"))
            for window in windows:
                timed = dtype == torch.bfloat16 and (
                    window == path_window or key != "")
                row = _paged_case(q, kp, vp, tab, lengths, lens, window,
                                  flush, timed)
                results[(label, str(dtype).split(".")[-1], window)] = row
                log("kernels", kernel="paged_decode_attention", case=label,
                    dtype=str(dtype).split(".")[-1], window=window,
                    shape=f"B{b}xK{k_}xG{g_}xhd{hd_}xbs{bs}xM{M}",
                    **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                       for k, v in row.items()})
    del bases, base
    bad = [k for k, r in results.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"paged_decode_attention disagrees with its plain "
                         f"version at {bad}")
    path = results[("path", "bfloat16", path_window)]
    log("kernels", kernel="paged_decode_attention", case="path",
        split_plan=f"splits={path['splits']},P={path['blocks_per_split']}",
        ctas=path["ctas"], live_ctas=path["live_ctas"],
        event_ms=f"{path['ms']:.6g}",
        profiler_pair_ms=f"{path['profiler_ms']:.6g}",
        bound_ms=f"{path['bound_ms']:.6g}",
        library_ms=f"{path['library_ms']:.6g}")
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:97",
        "max_abs_err": max(r["max_abs_err"] for (_, dt, _), r in results.items()
                           if dt == "bfloat16"),
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"],
    }


PROFILE_SESSIONS = 5
NOT_MEASURED = float("nan")     # a profiler time no session kept


def _device_event_count(prof) -> int:
    from torch.autograd import DeviceType

    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def profiled(body, what: str, cpu: bool = False, seen=None, again=None):
    """Runs ``body()`` under torch.profiler (device activity, and the host's
    too with ``cpu``) and returns (profile, body's result) of the first
    session that kept device events and for which ``seen(prof)`` holds, at
    most ``PROFILE_SESSIONS`` sessions; ``again()`` runs before each
    session after the first. Deep in a long run the tracer now and then
    keeps no device event of a whole session, several in a row at times
    (PERF.md), so an empty session is logged and taken again, not counted
    as a time. After the last session it returns (None, result), and the
    caller writes "not measured"."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    out = None
    for session in range(PROFILE_SESSIONS):
        if session and again is not None:
            again()
        with torch_profile(activities=acts) as prof:
            out = body()
            torch.cuda.synchronize()
        n = _device_event_count(prof)
        if n and (seen is None or seen(prof)):
            return prof, out
        log("profile", retry=f"session {session + 1} of {PROFILE_SESSIONS} "
            f"kept {n} device events, not enough for {what}")
    log("profile", not_measured=what,
        reason=f"{PROFILE_SESSIONS} profiler sessions kept too few events")
    return None, out


def _repeat(fn, flush: torch.Tensor, runs: int):
    def body():
        for _ in range(runs):
            flush.zero_()
            fn()
    return body


def device_ms(fn, flush: torch.Tensor, kernels=PAGED_KERNELS,
              runs: int = 25) -> float:
    """Device time per call of the named kernels (paged attention's pair by
    default) under torch.profiler, the L2 cache flushed before each call:
    what the CUDA event window of ``time_ms`` holds without the host's
    share. NaN when no session kept them (``profiled``)."""
    def ms(prof):
        return sum(t for name, (t, _) in _kernel_time_by_name(prof, runs)
                   .items() if any(k in name for k in kernels))

    fn()
    torch.cuda.synchronize()
    prof, _ = profiled(_repeat(fn, flush, runs), ",".join(kernels),
                       seen=lambda p: ms(p) > 0)
    return NOT_MEASURED if prof is None else ms(prof)


def after_ms(fn, flush: torch.Tensor, kernels, runs: int = 25) -> float:
    """Median, over ``runs`` calls of ``fn`` (a predecessor kernel, then the
    named kernel, the L2 flushed first), of the named kernel's end minus
    the end of the last kernel before it that is not a fill, from
    torch.profiler's device timestamps: what the kernel adds after the
    kernel it follows on the main path, a memset the wrapper launches
    included. A programmatic dependent launch hides part of it. NaN when
    no session kept every launch (``profiled``)."""
    from torch.autograd import DeviceType

    def gaps(prof):
        ev = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        out, prev = [], None    # prev: end of the last other non-fill kernel
        for _, end, name in ev:
            mine = any(k in name for k in kernels)
            if mine and prev is not None:
                out.append(end - prev)
            if "Fill" not in name:
                prev = None if mine else end
        return out

    fn()
    torch.cuda.synchronize()
    prof, _ = profiled(_repeat(fn, flush, runs),
                       f"{runs} launches of {','.join(kernels)} after another "
                       "kernel", seen=lambda p: len(gaps(p)) == runs)
    return (NOT_MEASURED if prof is None
            else float(np.median(gaps(prof))) / 1e3)


def host_ms(fn, runs: int = 200) -> float:
    """Host wall time per call of ``fn``, ``runs`` calls queued without a
    synchronisation between them: the wrapper's share of a call."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / runs
    torch.cuda.synchronize()
    return ms


# ---------------------------------------------------------------------------
# phase 3: the expert-parallel path's kernels against their plain versions
# ---------------------------------------------------------------------------

def _bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kernel_row(name, source, replaces, rows, main):
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"{name} disagrees with its plain version at {bad}")
    path = rows[main]
    KERNEL_ROWS[name] = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"]}
    return KERNEL_ROWS[name]


def _log_row(kernel, key, shape, row):
    log("kernels", kernel=kernel, case=key, shape=shape,
        **{k: (f"{v:.6g}" if isinstance(v, float) else v)
           for k, v in row.items() if not isinstance(v, dict)})


def ep_plan(num_experts: int):
    """The main path's placement plan: the experts on 4 ranks with one
    replica slot each, as Algorithm 1 plans them for a Zipf-skewed expert
    distribution (hot experts replicated)."""
    from repro_torch.core.duplication import duplicate_experts_host
    dist = 1.0 / np.arange(1, num_experts + 1)
    return duplicate_experts_host(dist / dist.sum(), EP_RANKS, DUP_SLOTS,
                                  4).plan


def ep_slot_experts(num_experts: int):
    """The slot -> expert map of ``ep_plan``."""
    from repro_torch.core.placement import slot_experts
    return slot_experts(ep_plan(num_experts), num_experts, EP_RANKS,
                        DUP_SLOTS)


def decode_live_batch(cfg, gen):
    """One real routed decode step's kernel inputs: 8 random tokens through
    the port's router (random router weight) and the decode path's packer
    under ``ep_plan``. Returns (send (S, cap, d) bf16, row_counts (S, 1),
    slot_experts (S,))."""
    from repro_torch.core.placement import to_device
    from repro_torch.moe.dispatch import pack_replicated
    from repro_torch.moe.router import route

    E, d = cfg.moe.num_experts, cfg.d_model
    moe = dataclasses.replace(cfg.moe, duplication_slots=DUP_SLOTS)
    plan = to_device(ep_plan(E), E, EP_RANKS, DUP_SLOTS, "cuda")
    tokens = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    w_router = torch.randn((d, E), generator=gen, device="cuda") * d ** -0.5
    send, counts, se = pack_replicated(tokens, route(w_router, moe, tokens),
                                       plan, moe, ep_ranks=EP_RANKS)[:3]
    return send.contiguous(), counts, se


def store_slot_rows(num_experts: int):
    """The ``decode_store`` case's slot -> row map on a replica store's
    16-row tensor (``runtime.store``: the 8 home rows, then a live and a
    back row per rank's replica slot): home slots read their home rows,
    every replica slot its own live row, so 12 slots name 12 rows."""
    rows = ep_slot_experts(num_experts).copy()
    e_loc = num_experts // EP_RANKS
    n_slots = e_loc + DUP_SLOTS
    for r in range(EP_RANKS):
        for i in range(DUP_SLOTS):
            rows[r * n_slots + e_loc + i] = num_experts + 2 * (r * DUP_SLOTS
                                                               + i)
    return rows


MOE_GEMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the paper's other MoE models' expert shapes, at the main path's decode and
# prefill row blocks under their own Zipf plan (4 ranks, 1 replica slot):
# llama-moe-3.5b d 4096, F 688 (not whole 64- or 128-column tiles), swiglu,
# 16 experts in 20 slots; switch-base-128 d 768, F 3072, relu, 128 experts
# in 132 slots; deepseek-v2-lite-16b d 2048, F 1408, swiglu, 64 experts in
# 68 slots
MOE_GEMM_MODELS = {"llama_moe": "llama-moe-3.5b", "switch": "switch-base-128",
                   "deepseek": "deepseek-v2-lite-16b"}
KERNEL_ROWS = {}                   # the kernels line's rows, by kernel name


def moe_gemm_case(x, counts, slot_map, cw, flush: torch.Tensor,
                  activation: str = "swiglu"):
    """One ``moe_gemm`` case held against its plain version: x (S, T, d),
    ``counts`` (S, B) live rows per block, ``slot_map`` (S,) weight rows
    of ``cw`` ({"w_gate", "w_up", "w_down"}). In bf16 also its time, device
    time, the plain version's and the library call's, against the bound of
    its live rows (each live expert's three matrices read once, its rows
    read and written once, 3 products of 2 d F operations per live row).
    fp32 is the same arithmetic summed over up to 14336 terms in another
    order; in bf16 h is rounded to bf16, so a last-bit difference of its
    fp32 sum moves a product by one bf16 ulp (test_kernels.py's 3e-2).
    ``activation``: swiglu, or relu / gelu (two matrices a live expert;
    ``w_gate`` is passed as the dispatch passes it, and never read)."""
    from repro_torch.kernels import ops, ref

    S, T, d = x.shape
    F = cw["w_up"].shape[-1]
    dtype = x.dtype
    gated = activation == "swiglu"
    args = (x, cw.get("w_gate"), cw["w_up"], cw["w_down"], slot_map,
            activation)
    got = ops.moe_gemm(*args, row_counts=counts)
    torch.cuda.synchronize()
    want = ref.moe_gemm_plain(*args, row_counts=counts)
    err = (got.float() - want.float()).abs()
    t = MOE_GEMM_TOL[dtype]
    ok = bool((err <= t + t * want.float().abs()).all()
              and torch.isfinite(got.float()).all())
    elem = cw["w_up"].element_size()
    live = ref.live_rows_mask(counts, T)
    n_live = int(live.sum())
    live_experts = len(set(slot_map[live.any(dim=1)].tolist()))
    named = len(set(slot_map.tolist()))
    matrix = (3 if gated else 2) * d * F * elem
    nbytes = live_experts * matrix + 2 * n_live * d * elem \
        + counts.numel() * 4 + S * 4
    flops = (6.0 if gated else 4.0) * n_live * d * F
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    row = {"max_abs_err": float(err.max()), "ok": ok,
           "live_rows": n_live, "live_experts": live_experts,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "slot_weight_ms": S * matrix / HBM_BYTES_PER_S * 1e3,
           "distinct_weight_ms": named * matrix / HBM_BYTES_PER_S * 1e3}
    del got, want, err
    if dtype == torch.bfloat16:
        def library():
            sm = slot_map.long()
            u = torch.bmm(x, cw["w_up"][sm])
            if gated:
                h = torch.nn.functional.silu(torch.bmm(x, cw["w_gate"][sm])) * u
            elif activation == "relu":
                h = torch.relu(u)
            else:
                h = torch.nn.functional.gelu(u, approximate="tanh")
            return torch.bmm(h, cw["w_down"][sm])
        row["ms"] = time_ms(lambda: ops.moe_gemm(*args, row_counts=counts),
                            flush)
        row["profiler_ms"] = device_ms(
            lambda: ops.moe_gemm(*args, row_counts=counts), flush,
            ("moe_gemm",))
        row["plain_ms"] = time_ms(
            lambda: ref.moe_gemm_plain(*args, row_counts=counts), flush,
            runs=5)
        row["library_ms"] = time_ms(library, flush, runs=5)
        row["device_tflops"] = flops / row["profiler_ms"] / 1e9
    return row


def moe_gemm_phase(flush: torch.Tensor, seed: int, cfg):
    """Both main-path shapes with every row live: decode (12 slots x cap 8
    rows, one row block per slot) and prefill (12 slots x 4 source ranks x
    cap 32 rows), fp32 and bf16; and in bf16 the rows and counts of one
    real routed decode step (``decode_live``) and the decode shape on a
    replica store's 16-row weight tensors (``decode_store``: 12 slots read
    12 distinct rows, as the EP store run's replica slots do). The main
    slot map names 8 distinct experts in 12 slots: the plan puts every
    rank's replica slot on the hottest expert, which 4 slots then share.
    The Token-to-Expert correction round's shape (``prefill_correction``)
    is held in the t2e phase, on a real round's rows and counts. Then, in
    bf16, the decode and prefill blocks at ``MOE_GEMM_MODELS``' widths."""
    E, d, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    se_np = ep_slot_experts(E)
    S = len(se_np)
    se = torch.tensor(se_np, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    blocks = {"decode": (8, 1), "prefill": (4 * 32, 4)}       # (T, B)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        w = {n: (torch.randn(shape, generator=gen, device="cuda")
                 * scale).to(dtype)
             for n, shape, scale in (("w_gate", (E, d, F), d ** -0.5),
                                     ("w_up", (E, d, F), d ** -0.5),
                                     ("w_down", (E, F, d), F ** -0.5))}
        cases = {}
        for case, (T, B) in blocks.items():
            x = torch.randn((S, T, d), generator=gen, device="cuda").to(dtype)
            counts = torch.full((S, B), T // B, dtype=torch.int32,
                                device="cuda")
            cases[case] = (x, counts, se)
        store_w = None
        if dtype == torch.bfloat16:
            cases["decode_live"] = decode_live_batch(cfg, gen)
            # the store's rows: homes, then copies standing in for the
            # replica rows (each slot's weights come from its own row)
            store_w = {n: torch.cat([t, t]) for n, t in w.items()}
            cases["decode_store"] = (
                cases["decode"][0], cases["decode"][1],
                torch.tensor(store_slot_rows(E), device="cuda"))
        for case, (x, counts, slot_map) in cases.items():
            S, T, _ = x.shape
            cw = store_w if case == "decode_store" else w
            row = moe_gemm_case(x, counts, slot_map, cw, flush)
            if case == "prefill" and "device_tflops" in row:
                MEASURED["moe_gemm_prefill_tflops"] = row["device_tflops"]
            key = f"{str(dtype).split('.')[-1]}/{case}"
            rows[key] = row
            _log_row("moe_gemm", key, f"S{S}xT{T}xd{d}xF{F}", row)
        del w, cases, store_w
        torch.cuda.empty_cache()
    from repro_torch.configs.registry import get_config
    for label, arch in MOE_GEMM_MODELS.items():
        mc = get_config(arch)
        E, d, F = mc.moe.num_experts, mc.d_model, mc.moe.d_ff_expert
        sm = torch.tensor(ep_slot_experts(E), device="cuda")
        S = len(sm)
        w = {n: (torch.randn(shape, generator=gen, device="cuda")
                 * scale).to(torch.bfloat16)
             for n, shape, scale in (("w_gate", (E, d, F), d ** -0.5),
                                     ("w_up", (E, d, F), d ** -0.5),
                                     ("w_down", (E, F, d), F ** -0.5))}
        for case, (T, B) in blocks.items():
            x = torch.randn((S, T, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
            counts = torch.full((S, B), T // B, dtype=torch.int32,
                                device="cuda")
            row = moe_gemm_case(x, counts, sm, w, flush, mc.activation)
            key = f"bfloat16/{label}_{case}"
            rows[key] = row
            _log_row("moe_gemm", key, f"S{S}xT{T}xd{d}xF{F}/{mc.activation}",
                     row)
            del x
        del w
        torch.cuda.empty_cache()
    MEASURED["moe_gemm_rows"] = rows
    return _kernel_row("moe_gemm", "src/repro_torch/kernels/csrc/moe_gemm.cu",
                       "src/repro/kernels/moe_gemm.py:60", rows,
                       "bfloat16/decode")


# the paper's other MoE models' routers: E 16 with K 4, E 128 with K 1 and
# with K 2, E 64 with K 6, at the main path's decode and prefill row counts
ROUTER_MODELS = {"llama_moe": "llama-moe-3.5b", "switch": "switch-base-128",
                 "arctic": "arctic-480b", "deepseek": "deepseek-v2-lite-16b"}
ROUTER_SWEEP = dict(T=(1, 8, 63, 64, 65, 128, 512, 4096), R=(1, 4),
                    E=(8, 16, 17, 128, 256), K=range(1, 9))
HIST_SWEEP = dict(C=(4, 13, 32, 33, 128, 133), N=(0, 16, 256, 40000),
                  R=(1, 4, 33))
# the packer's shapes for the paper's other MoE models (4 ranks, one replica
# slot a rank): (ranks, pairs a rank, classes). Decode packs a rank's
# slots plus the overflow class (8 tokens x K pairs), prefill every slot
# plus overflow (128 tokens a rank x K); C 128 the router's count width
HIST_MODEL_CASES = {"llama_moe_decode": (EP_RANKS, 8 * 4, 4 + 1 + 1),
                    "llama_moe_prefill": (EP_RANKS, 128 * 4, 4 * 5 + 1),
                    "switch_decode": (EP_RANKS, 8, 32 + 1 + 1),
                    "switch_prefill": (EP_RANKS, 128, 4 * 33 + 1),
                    "arctic_decode": (EP_RANKS, 8 * 2, 32 + 1 + 1),
                    "arctic_prefill": (EP_RANKS, 128 * 2, 4 * 33 + 1),
                    "deepseek_decode": (EP_RANKS, 8 * 6, 16 + 1 + 1),
                    "deepseek_prefill": (EP_RANKS, 128 * 6, 4 * 17 + 1),
                    "c128": (EP_RANKS, 256, 128)}
TIE_ROWS = 3                       # rows of equal logits at each rank's start
# the flush before each pair timing: 1 GiB keeps the device busy for about
# 0.35 ms, long enough for the host to queue the predecessor and the kernel
# before the device reaches them, so the pair's time is the device's alone
PAIR_LEAD_BYTES = 1 << 30


def _route_check(logits, K: int, tie_rows: int = TIE_ROWS):
    """One kernel call held against the plain version: indices exact except
    on near-tie rows (sorted top-(K+1) probabilities holding two within 4
    ulps, which two orders of summation may break differently), the first
    ``tie_rows`` rows of every rank (exact ties, planted by
    ``_route_logits``; 0 for a model's own logits) routed to experts
    0..K-1, fp32 outputs within 1e-6, counts exact unless a near tie moved
    an index."""
    from repro_torch.kernels import ops, ref

    got = ops.fused_topk_route(logits, K)
    torch.cuda.synchronize()
    want = ref.fused_topk_route_plain(logits, K)
    top = torch.sort(want[2], dim=-1, descending=True).values[..., :K + 1]
    gaps = top[..., :-1] - top[..., 1:]
    near = (gaps <= 4 * torch.finfo(torch.float32).eps
            * top[..., :-1]).any(-1)
    differ = (got[0] != want[0]).any(-1)
    ties = torch.arange(K, dtype=torch.int32, device=logits.device)
    ties_ok = bool((got[0][:, :tie_rows] == ties).all())
    err = max(float((g - w).abs().max()) for g, w in
              zip(got[1:4], want[1:4]))
    counts_ok = torch.equal(got[4], want[4]) or bool(differ.any())
    ok = (bool((~differ | near).all()) and ties_ok and err <= 1e-6
          and counts_ok)
    return {"max_abs_err": err, "ok": ok, "near_tie_rows": int(near.sum()),
            "index_mismatch_rows": int(differ.sum())}


def _route_logits(gen, R, T, E):
    logits = torch.randn((R, T, E), generator=gen, device="cuda") * 2.0
    logits[:, :TIE_ROWS] = 0.25
    return logits


def router_phase(flush: torch.Tensor, seed: int, cfg):
    """The main path's shapes, timed: decode routes the 8 replicated tokens
    once (1 x 8 x 8, K 2), prefill 4 ranks' 128 tokens in one launch; and
    4096 rows of one batch (``long``, the cluster path). Each is also timed
    after the logits' matmul that precedes it in ``moe/router.py``
    (``pair_ms`` by events around both, ``after_ms`` from the profiler;
    ``PAIR_LEAD_BYTES`` flushed first), where a programmatic dependent
    launch can overlap the two, and by the wrapper's host time
    (``host_ms``); the decode and prefill cases also at ``ROUTER_MODELS``'
    widths (E 16 / K 4, E 128 / K 1, E 128 / K 2). Then, untimed, every T of 1, 8, 63, 64, 65, 128, 512 and
    4096 with R of 1 and 4, E of 8, 16, 17 and 256 and K of 1..8: packed
    rows (E <= 16) and one warp per row (E > 16), one CTA or a cluster of
    3 to 8 CTAs per rank, warps that loop over rows. Every case is held to
    ``_route_check``; near-tie rows are counted and printed."""
    from repro_torch.kernels import ops, ref

    from repro_torch.configs.registry import get_config

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    lead = torch.empty(PAIR_LEAD_BYTES, dtype=torch.uint8, device="cuda")
    rows = {}
    shapes = {"decode": (1, 8), "prefill": (EP_RANKS, 128),
              "long": (1, 4096)}
    cases = [(c, R, T, cfg) for c, (R, T) in shapes.items()]
    cases += [(f"{label}_{c}", R, T, get_config(arch))
              for label, arch in ROUTER_MODELS.items()
              for c, (R, T) in shapes.items() if c != "long"]
    for case, R, T, mc in cases:
        E, K, d = mc.moe.num_experts, mc.moe.top_k, mc.d_model
        logits = _route_logits(gen, R, T, E)
        row = _route_check(logits, K)
        nbytes = 4 * (2 * R * T * E + 2 * R * T * K + R * T + R * E)
        flops = R * T * E * (4 + 2 * K)      # max, exp, sum, divide; K rounds
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, FP32_FLOPS)
        offs = (torch.arange(R, device="cuda") * E)[:, None, None]
        x = torch.randn((R, T, d), generator=gen, device="cuda")
        w = torch.randn((d, E), generator=gen, device="cuda") * d ** -0.5

        def library():
            p = torch.softmax(logits, dim=-1)
            g, i = torch.topk(p, K, dim=-1)
            return g, i, torch.bincount((i + offs).reshape(-1),
                                        minlength=R * E)

        def pair():
            return ops.fused_topk_route(torch.matmul(x, w), K)
        row.update(
            ms=time_ms(lambda: ops.fused_topk_route(logits, K), flush),
            profiler_ms=device_ms(lambda: ops.fused_topk_route(logits, K),
                                  flush, ("topk_route",)),
            pair_ms=time_ms(pair, lead),
            after_ms=after_ms(pair, lead, ("topk_route",)),
            host_ms=host_ms(lambda: ops.fused_topk_route(logits, K)),
            plain_ms=time_ms(lambda: ref.fused_topk_route_plain(logits, K),
                             flush),
            library_ms=time_ms(library, flush))
        rows[case] = row
        _log_row("fused_topk_route", case, f"R{R}xT{T}xE{E}xK{K}", row)
    sweep = {}
    for T in ROUTER_SWEEP["T"]:
        for R in ROUTER_SWEEP["R"]:
            for e in ROUTER_SWEEP["E"]:
                logits = _route_logits(gen, R, T, e)
                for k in ROUTER_SWEEP["K"]:
                    sweep[f"R{R}xT{T}xE{e}xK{k}"] = _route_check(logits, k)
    _log_sweep("fused_topk_route", sweep)
    rows.update(sweep)
    return _kernel_row("fused_topk_route",
                       "src/repro_torch/kernels/csrc/topk_router.cu",
                       "src/repro/kernels/topk_router.py:66", rows, "decode")


def _log_sweep(kernel, sweep):
    for key, row in sweep.items():
        if not row["ok"]:
            _log_row(kernel, key, key, row)
    log("kernels", kernel=kernel, case="sweep", cases=len(sweep),
        failed=sum(not r["ok"] for r in sweep.values()),
        max_abs_err=f"{max(r['max_abs_err'] for r in sweep.values()):.6g}",
        **{k: sum(r[k] for r in sweep.values())
           for k in ("near_tie_rows", "index_mismatch_rows")
           if k in next(iter(sweep.values()))})


def _hist_check(ids, C: int):
    """One kernel call held against the plain version: both outputs
    exact."""
    from repro_torch.kernels import ops, ref

    got = ops.histogram_offsets(ids, C)
    torch.cuda.synchronize()
    want = ref.histogram_offsets_plain(ids, C)
    ok = all(torch.equal(g, w) for g, w in zip(got, want))
    return {"max_abs_err": 0.0 if ok else float("inf"), "ok": ok}


def histogram_phase(flush: torch.Tensor, seed: int):
    """The sort packer's shapes, timed: prefill (4 ranks x 256 pairs, 12
    slots + the overflow class) and decode (4 ranks x 16 pairs, 3 slots +
    1), each also after the stable argsort that precedes it in
    ``moe/dispatch.py::_pack_sort`` (``pair_ms`` by events, ``after_ms``
    from the profiler; ``PAIR_LEAD_BYTES`` flushed first) and by the
    wrapper's host time (``host_ms``); the most classes the kernel
    takes, where its shared memory is full; and the packer's shapes for
    the paper's other MoE models (``HIST_MODEL_CASES``: 6 and 21 classes
    on the warp path, 34, 128 and 133 on the CTA-per-row path). Then,
    untimed, C of 4, 13, 32 (the warp-per-row kernel's last), 33 (the
    CTA-per-row kernel's first), 128 and 133, N of 0, 16, 256 and 40000 and
    R of 1, 4 and 33 (two CTAs of warps), ids from -2 to C + 2. Exact."""
    from repro_torch.kernels import histogram, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    lead = torch.empty(PAIR_LEAD_BYTES, dtype=torch.uint8, device="cuda")
    rows = {}
    for case, (R, N, C) in {"decode": (EP_RANKS, 16, 4),
                            "prefill": (EP_RANKS, 256, 13),
                            "max_classes": (1, 40000,
                                            histogram.MAX_CLASSES),
                            **HIST_MODEL_CASES}.items():
        ids = torch.randint(0, C, (R, N), generator=gen, device="cuda",
                            dtype=torch.int32)
        row = _hist_check(ids, C)
        row["bound_ms"], row["bound_by"] = _bound(
            4 * (R * N + 2 * R * C), R * (N + C), FP32_FLOPS)
        offs = (torch.arange(R, device="cuda", dtype=torch.int32) * C)[:, None]

        def library():
            counts = torch.bincount((ids + offs).reshape(-1),
                                    minlength=R * C).reshape(R, C)
            return counts, torch.cumsum(counts, dim=1) - counts

        def pair():
            torch.argsort(ids, dim=1, stable=True)
            return ops.histogram_offsets(ids, C)
        row.update(
            ms=time_ms(lambda: ops.histogram_offsets(ids, C), flush),
            profiler_ms=device_ms(lambda: ops.histogram_offsets(ids, C),
                                  flush, ("histogram_offsets",)),
            pair_ms=time_ms(pair, lead),
            after_ms=after_ms(pair, lead, ("histogram_offsets",)),
            host_ms=host_ms(lambda: ops.histogram_offsets(ids, C)),
            plain_ms=time_ms(lambda: ref.histogram_offsets_plain(ids, C),
                             flush),
            library_ms=time_ms(library, flush))
        rows[case] = row
        _log_row("histogram_offsets", case, f"R{R}xN{N}xC{C}", row)
    sweep = {}
    for C in HIST_SWEEP["C"]:
        for N in HIST_SWEEP["N"]:
            for R in HIST_SWEEP["R"]:
                ids = torch.randint(-2, C + 3, (R, N), generator=gen,
                                    device="cuda", dtype=torch.int32)
                sweep[f"R{R}xN{N}xC{C}"] = _hist_check(ids, C)
    _log_sweep("histogram_offsets", sweep)
    rows.update(sweep)
    return _kernel_row("histogram_offsets",
                       "src/repro_torch/kernels/csrc/histogram.cu",
                       "src/repro/kernels/histogram.py:60", rows, "decode")


def launch_floor_phase(flush: torch.Tensor) -> None:
    """The card's launch floor: an empty kernel (``csrc/histogram.cu``'s
    ``empty_kernel``, one CTA of 32 threads, launched through ``ctypes`` as
    the kernels are), timed as they are: CUDA events, L2 flushed first, and
    device time under torch.profiler."""
    from repro_torch.kernels import histogram

    log("kernels", kernel="launch_floor",
        ms=f"{time_ms(histogram.launch_empty, flush):.6g}",
        profiler_ms=f"{device_ms(histogram.launch_empty, flush, ('empty_kernel',)):.6g}",
        host_ms=f"{host_ms(histogram.launch_empty):.6g}")


# Griffin's rnn width and the training path's (batch, seq)
SCAN_D, SCAN_TRAIN = 2560, (2, 1024)


# Untimed shapes (B, S, D, aligned) at the edges of the scan kernels' ring
# (csrc/rg_lru.cu: 64-channel strips, 32-step tiles, rings of 4 tiles in the
# forward and 3 in the backward): S ragged and shorter than either ring, S
# ragged past both, D ragged by the strip with D % 4 == 0 (TMA boxes past D)
# and with D % 4 == 2 (the 4-byte copies), fewer strips than 2 x 132 and more
# than three CTAs a SM hold at once, and rows that start 4 bytes past a
# 16-byte boundary (the 4-byte copies at an aligned D).
SCAN_EDGE_CASES = {"s_under_ring": (2, 77, SCAN_D, True),
                   "s_past_ring": (2, 1191, SCAN_D, True),
                   "d_strip_ragged": (2, 131, SCAN_D + 8, True),
                   "d_mod4_ragged": (3, 131, SCAN_D + 10, True),
                   "few_strips": (1, 65, 1600, True),
                   "many_strips": (12, 65, SCAN_D, True),
                   "misaligned": (2, 389, SCAN_D, False)}


def _off16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def rg_lru_phase(flush: torch.Tensor, seed: int):
    """Griffin's prefill shapes (batch 8, 3072- and 2048-token prompts, rnn
    width 2560; h0 zero, as a prefill starts), the train step's (2 x 1024),
    one step, a ragged shape and a long one with a nonzero h0, all timed
    (the train and prefill shapes also by the profiler); then, untimed, the
    ring's edges (``SCAN_EDGE_CASES``). Both outputs must equal the plain
    version bit for bit: the kernel rounds the product and the sum apart,
    as the plain version does. No single PyTorch call computes a
    first-order linear recurrence, so there is no library time."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    rows = {}
    cases = {"prefill": (8, 3072, SCAN_D, True, True),
             "prefill_2048": (8, 2048, SCAN_D, True, True),
             "train": (*SCAN_TRAIN, SCAN_D, False, True),
             "one_step": (8, 1, SCAN_D, False, True),
             "ragged": (2, 1025, 257, False, True),
             "long_h0": (4, 2000, 256, False, True)}
    cases.update((k, (B, S, D, False, False))
                 for k, (B, S, D, _) in SCAN_EDGE_CASES.items())
    for case, (B, S, D, zero_h0, timed) in cases.items():
        a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.49 + 0.5
        b = torch.randn((B, S, D), generator=gen, device="cuda") * 0.1
        h0 = (torch.zeros((B, D), device="cuda") if zero_h0 else
              torch.randn((B, D), generator=gen, device="cuda"))
        if case == "misaligned":
            a, b = _off16(a), _off16(b)
        got = ops.rg_lru_scan(a, b, h0)
        torch.cuda.synchronize()
        want = ref.rg_lru_scan_plain(a, b, h0)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        row = {"max_abs_err": err, "ok": ok}
        if timed:
            # a and b read once, every h written once, h0 read, h_last
            # written; one product and one sum per element
            row["bound_ms"], row["bound_by"] = _bound(
                4 * (3 * B * S * D + 2 * B * D), 2 * B * S * D, FP32_FLOPS)
            row["ms"] = time_ms(lambda: ops.rg_lru_scan(a, b, h0), flush)
            if case in ("train", "prefill", "prefill_2048"):
                row["profiler_ms"] = device_ms(
                    lambda: ops.rg_lru_scan(a, b, h0), flush,
                    ("rg_lru_scan_kernel",))
            row["plain_ms"] = time_ms(
                lambda: ref.rg_lru_scan_plain(a, b, h0), flush, runs=5)
            row["library_ms"] = None
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows[case] = row
        _log_row("rg_lru_scan", case, f"B{B}xS{S}xD{D}", row)
        del a, b, h0, got, want
    torch.cuda.empty_cache()
    return _kernel_row("rg_lru_scan", "src/repro_torch/kernels/csrc/rg_lru.cu",
                       "src/repro/kernels/rg_lru.py:49", rows, "prefill")


# ---------------------------------------------------------------------------
# phase 3: the training path's backward kernels against their plain versions
# ---------------------------------------------------------------------------

# which of (d_gates, d_probs, d_lse) reach the router's backward; a missing
# one is a null pointer the kernel never reads
ROUTE_BWD_GRADS = ((True, True, True), (True, False, False),
                   (False, True, False), (False, False, True),
                   (True, False, True), (False, True, True),
                   (True, True, False))
ROUTE_BWD_SWEEP = dict(T=(1, 8, 63, 64, 65, 2048), R=(1, 4),
                       E=(1, 2, 5, 8, 16, 17, 32, 64, 128, 256), K=(1, 2, 8))
# the train step's router at the paper's other MoE models' widths: (1 x 2048
# rows, E, K) of llama-moe-3.5b, switch-base-128, arctic-480b and
# deepseek-v2-lite-16b
ROUTE_BWD_MODELS = {"llama_moe_train": (16, 4), "switch_train": (128, 1),
                    "arctic_train": (128, 2), "deepseek_train": (64, 6)}
ROUTE_BWD_TOL = 1e-6
TRAIN_CASES = {}                   # the train phase's captured kernel inputs


def _route_bwd_check(probs, idx, grads):
    """One backward launch held against the plain version within
    ``ROUTE_BWD_TOL`` (the two sum ``probs * dp`` over E in other orders)."""
    from repro_torch.kernels import ops, ref

    got = ops.fused_topk_route_bwd(probs, idx, *grads)
    torch.cuda.synchronize()
    want = ref.fused_topk_route_bwd_plain(probs, idx, *grads)
    err = float((got - want).abs().max())
    return {"max_abs_err": err, "ok": bool(torch.isfinite(got).all())
            and err <= ROUTE_BWD_TOL}


def _route_bwd_bound(R, T, E, K):
    # probs, d_probs read and d_logits written (E each), idx and d_gates
    # read (K each), d_lse read; per element a product, a difference, two
    # more products, a sum and the reduction's add
    return _bound(4 * (3 * R * T * E + 2 * R * T * K + R * T),
                  6 * R * T * E, FP32_FLOPS)


def _route_bwd_timed(probs, idx, grads, logits, flush):
    """The kernel (events and profiler), the plain version and the PyTorch
    chain that computes the same gradient (``torch.autograd.grad`` through
    softmax, the gather of the chosen probs and logsumexp, its forward
    built once outside the timing)."""
    from repro_torch.kernels import ops, ref

    x = logits.detach().clone().requires_grad_()
    p = torch.softmax(x, dim=-1)
    outs = (torch.gather(p, -1, idx.long()), p, torch.logsumexp(x, dim=-1))
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]

    def library():
        return torch.autograd.grad([o for o, _ in pairs], x,
                                   [g for _, g in pairs], retain_graph=True)
    return dict(
        ms=time_ms(lambda: ops.fused_topk_route_bwd(probs, idx, *grads),
                   flush),
        profiler_ms=device_ms(lambda: ops.fused_topk_route_bwd(
            probs, idx, *grads), flush, ("topk_route_bwd",)),
        plain_ms=time_ms(lambda: ref.fused_topk_route_bwd_plain(
            probs, idx, *grads), flush),
        library_ms=time_ms(library, flush))


def router_bwd_phase(flush: torch.Tensor, seed: int, cfg):
    """``fused_topk_route_bwd`` at the router phase's shapes (decode 1 x 8,
    prefill 4 x 128) and the training path's (1 x 2048: a 4 x 512 batch),
    E 8, K 2, every gradient present, the first ``TIE_ROWS`` rows of each
    rank exact ties; timed by CUDA events (L2 flushed), the profiler, the
    plain version and the autograd chain (``library_ms``). Then, untimed,
    every T, R, E and K of ``ROUTE_BWD_SWEEP`` with each subset of the
    gradients (``ROUTE_BWD_GRADS``), E up to 256 (one warp a row, PER
    experts a lane past 32). The train step's shape is timed at the other
    models' widths too (``ROUTE_BWD_MODELS``: E 16 / K 4, E 128 / K 1 and
    K 2). The train phase adds the case of a real train step's layer-0
    inputs."""
    from repro_torch.kernels import ops

    E, K = cfg.moe.num_experts, cfg.moe.top_k
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)

    def case(R, T, e, k, use):
        logits = _route_logits(gen, R, T, e)
        idx, _, probs, _, _ = ops.fused_topk_route(logits, k)
        grads = [torch.randn(s, generator=gen, device="cuda") if u else None
                 for s, u in zip(((R, T, k), (R, T, e), (R, T)), use)]
        return logits, probs, idx, grads
    rows = {}
    named = {name: (R, T, E, K) for name, (R, T) in {
        "decode": (1, 8), "prefill": (EP_RANKS, 128),
        "train": (1, 2048)}.items()}
    named.update({name: (1, 2048, e, k)
                  for name, (e, k) in ROUTE_BWD_MODELS.items()})
    for name, (R, T, E, K) in named.items():
        logits, probs, idx, grads = case(R, T, E, K, (True,) * 3)
        row = _route_bwd_check(probs, idx, grads)
        row["bound_ms"], row["bound_by"] = _route_bwd_bound(R, T, E, K)
        row.update(_route_bwd_timed(probs, idx, grads, logits, flush))
        rows[name] = row
        _log_row("fused_topk_route_bwd", name, f"R{R}xT{T}xE{E}xK{K}", row)
    sweep = {}
    for T in ROUTE_BWD_SWEEP["T"]:
        for R in ROUTE_BWD_SWEEP["R"]:
            for e in ROUTE_BWD_SWEEP["E"]:
                for k in ROUTE_BWD_SWEEP["K"]:
                    if k > e:
                        continue
                    for use in ROUTE_BWD_GRADS:
                        _, probs, idx, grads = case(R, T, e, k, use)
                        key = (f"R{R}xT{T}xE{e}xK{k}/"
                               + "".join("gpl"[i] if u else "-"
                                         for i, u in enumerate(use)))
                        sweep[key] = _route_bwd_check(probs, idx, grads)
    _log_sweep("fused_topk_route_bwd", sweep)
    rows.update(sweep)
    row = _kernel_row("fused_topk_route_bwd",
                      "src/repro_torch/kernels/csrc/topk_router.cu",
                      "src/repro/kernels/topk_router.py:66", rows, "train")
    row["gradient_of"] = "fused_topk_route"
    return row


# moe_gemm_bwd against its plain version, each output against its largest
# element: bf16 within 2 bf16 ulps of it (h, dg and du round to bf16 after
# fp32 sums that the two add in other orders; observed 1 ulp), fp32 within
# 1e-4 of it (the forward's fp32 tolerance)
MOE_BWD_ULPS, MOE_BWD_F32_REL = 2, 1e-4
MOE_BWD_KERNELS = ("moe_bwd_",)          # its launches' kernel names
# its parts, by kernel name (the earlier mma.sync design's too: weight<2> /
# weight<1>, no pack; the FMA path's two weight kernels share one name)
MOE_BWD_PARTS = {"rows": ("moe_bwd_rows",), "pack": ("moe_bwd_pack",),
                 "dh": ("moe_bwd_dh",), "hidden": ("moe_bwd_hidden",),
                 "input": ("moe_bwd_input",),
                 "weight_gu": ("moe_bwd_weight_gu", "moe_bwd_weight<2"),
                 "weight_down": ("moe_bwd_weight_down", "moe_bwd_weight<1"),
                 "weight_fma": ("moe_bwd_weight_fma",)}
MOE_BWD_REDUCED = dict(d=1024, F=2048)   # the gelu / relu / fp32 cases
# the EP train step's layer at the paper's other MoE models' widths (4 x 512
# tokens over 4 ranks, identity plan): llama-moe-3.5b swiglu at F 688 (16
# slots x 4 x 160 rows, K 4), switch-base-128 relu at d 768 / F 3072 (128
# slots x 4 x 8 rows, K 1), deepseek-v2-lite-16b swiglu at d 2048 / F 1408
# (64 slots, K 6)
MOE_BWD_MODELS = {"llama_moe_train": "llama-moe-3.5b",
                  "switch_train": "switch-base-128",
                  "deepseek_train": "deepseek-v2-lite-16b"}


def ep_train_layer(cfg, gen, dup_slots: int):
    """One EP train layer's ``moe_gemm`` inputs at the train step's shape:
    ``TRAIN_BATCH * TRAIN_SEQ`` random tokens over ``EP_RANKS`` ranks through
    a random router at the model's top-k, then the dispatch's replica choice
    and packer at the model's capacity factor under the identity plan
    (``dup_slots`` 0, the training layout: 8 slots x 4 x 160 rows) or
    ``ep_plan`` (one replica slot a rank, the serving layout: 12 slots
    naming 8 experts). Returns (x (S, R cap, d) bf16, zero where the packer
    left rows empty, row_counts (S, R), slot map (S,))."""
    from repro_torch.core.placement import identity_plan, to_device
    from repro_torch.moe import dispatch as ep
    from repro_torch.moe.router import route

    E, K, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    R, T = EP_RANKS, TRAIN_BATCH * TRAIN_SEQ // EP_RANKS
    host = ep_plan(E) if dup_slots else identity_plan(E, R, 0, 4)
    plan = to_device(host, E, R, dup_slots, "cuda")
    n_slots = E // R + dup_slots
    S = R * n_slots
    cap = ep.capacity(T, K, S, cfg.moe.capacity_factor)
    x = torch.randn((R, T, d), generator=gen, device="cuda").to(torch.bfloat16)
    w_router = torch.randn((d, E), generator=gen, device="cuda") * d ** -0.5
    with torch.no_grad():
        ro = route(w_router, cfg.moe, x)
        gslot = ep.choose_replica(plan, ro.expert_idx.reshape(R, T * K),
                                  ep._salt(T, K, "cuda"))
        send, _, _, counts, _ = ep._pack_sort(
            x, torch.arange(T * K, device="cuda") // K, gslot,
            torch.ones_like(gslot, dtype=torch.bool), num_classes=S, cap=cap)
    recv = send.reshape(R, R, n_slots, cap, d).transpose(0, 1) \
               .transpose(1, 2).reshape(S, R * cap, d).contiguous()
    return (recv, counts.T.contiguous(),
            ep._slot_map(plan, E, dup_slots, S, "cuda"))


def _moe_bwd_weights(gen, E, d, F, dtype):
    return {n: (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
            for n, shape, scale in (("w_gate", (E, d, F), d ** -0.5),
                                    ("w_up", (E, d, F), d ** -0.5),
                                    ("w_down", (E, F, d), F ** -0.5))}


def device_parts_ms(fn, flush: torch.Tensor, parts: dict,
                    runs: int = 25) -> tuple:
    """Device time per call of each part (kernel names matching one of its
    patterns; the first part that matches takes a kernel) under
    torch.profiler, the L2 cache flushed before each call, as
    ``device_ms``; and the share of the expected kernel events the
    profiler kept. A session deep in a long run can keep only some of a
    kernel's launches (PERF.md), so each part is its mean time a
    launch times its launches a call (rounded from the events seen, at
    least one), not the sum over the session divided by ``runs``. NaN
    parts and a share of 0 when no session kept them (``profiled``)."""
    def split(prof):
        total = {k: 0.0 for k in parts}
        events = {k: 0 for k in parts}
        for name, (t, n) in _kernel_time_by_name(prof, 1).items():
            part = next((k for k, pats in parts.items()
                         if any(p in name for p in pats)), None)
            if part is not None:
                total[part] += t
                events[part] += n
        out, kept, want = {}, 0, 0
        for k in parts:
            per_call = max(1, round(events[k] / runs)) if events[k] else 0
            out[k] = total[k] / events[k] * per_call if events[k] else 0.0
            kept += events[k]
            want += per_call * runs
        return out, (kept / want if want else 0.0)

    fn()
    torch.cuda.synchronize()
    prof, _ = profiled(_repeat(fn, flush, runs), ",".join(sorted(parts)),
                       seen=lambda p: sum(split(p)[0].values()) > 0)
    if prof is None:
        return {k: NOT_MEASURED for k in parts}, 0.0
    return split(prof)


def moe_bwd_part_bounds(n_live, live_experts, S, T, d, F, E, act, elem,
                        peak, n_counts) -> dict:
    """Each part's bound, (ms, "bytes" or "operations"), from the shapes as
    ``_bound`` reckons them: each input read once, each output written
    once, the operations of the live rows only (the packing's padding is
    the kernel's own work). pack reads the live rows of x and dy and writes
    them packed, and zeros into dx's dead rows; rows reads the counts and
    the slot map and writes a packed row's index; dh writes fp32, which
    hidden reads. The earlier mma.sync design had no pack or dh launch (its
    hidden part computed dh)."""
    gated = act == "swiglu"
    k = 2 if gated else 1                # dg, du: gate and up parts
    w = d * F * live_experts * elem      # one live expert matrix set
    ops = 2.0 * n_live * d * F
    parts = {
        "rows": ((n_counts + S + n_live) * 4, 0.0),
        "pack": ((4 * n_live * d + (S * T - n_live) * d) * elem, 0.0),
        "dh": ((n_live * d + n_live * F * 2) * elem + w, ops),
        "hidden": ((n_live * d + (k + 1) * n_live * F) * elem
                   + n_live * F * 4 + k * w, k * ops),
        "input": ((k * n_live * F + n_live * d) * elem + k * w, k * ops),
        "weight_gu": ((n_live * d + k * n_live * F) * elem
                      + k * E * d * F * elem, k * ops),
        "weight_down": ((n_live * F + n_live * d) * elem + E * d * F * elem,
                        ops)}
    parts["weight_fma"] = tuple(parts["weight_gu"][i] + parts["weight_down"][i]
                                for i in range(2))
    return {name: _bound(b, f, peak) for name, (b, f) in parts.items()}


def moe_bwd_case(x, wg, wu, wd, slot_map, dy, act, counts, flush,
                 runs: int = 10) -> dict:
    """``moe_gemm_bwd`` on one set of inputs held against its plain version
    (``MOE_BWD_ULPS`` / ``MOE_BWD_F32_REL``; two calls bit-equal), timed by CUDA events and the profiler (L2 flushed), beside
    its plain version, the library chain (``torch.autograd.grad`` through
    the weights' gather and ``bmm``, the forward's library column, built
    once outside the timing) and its bound: each input read once (the live
    rows of x and dy, every live expert's matrices, the counts), each
    output written once (dx and the whole weight gradients), 8 products of
    2 rows d F operations a live row (5 without a gate)."""
    from repro_torch.kernels import ops, ref

    args = (x, wg, wu, wd, slot_map, dy, act, counts)
    before = ops.LAUNCHES["moe_gemm_bwd"]
    got = ops.moe_gemm_bwd(*args)
    again = ops.moe_gemm_bwd(*args)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["moe_gemm_bwd"] - before
    want = ref.moe_gemm_bwd_plain(*args)
    dtype = x.dtype
    ok, errs = True, {}
    for name, g, a, w in zip(("dx", "d_w_gate", "d_w_up", "d_w_down"), got,
                             again, want):
        if w is None:
            ok = ok and g is None
            continue
        err = float((g.float() - w.float()).abs().max())
        scale = max(float(w.float().abs().max()), 1e-30)
        tol = (MOE_BWD_ULPS * 2.0 ** (np.floor(np.log2(scale)) - 7)
               if dtype == torch.bfloat16 else MOE_BWD_F32_REL * scale)
        errs[name] = err
        ok = (ok and torch.equal(g, a) and bool(torch.isfinite(g).all())
              and err <= tol)
    del got, again, want
    S, T, d = x.shape
    E, _, F = wu.shape
    live = ref.live_rows_mask(counts, T)
    n_live = int(live.sum())
    live_experts = len(set(slot_map[live.any(dim=1)].tolist()))
    elem = x.element_size()
    n_mat = 3 if act == "swiglu" else 2
    nbytes = (2 * n_live * d + live_experts * n_mat * d * F + S * T * d
              + E * n_mat * d * F) * elem + counts.numel() * 4 + S * 4
    flops = (8 if act == "swiglu" else 5) * 2.0 * n_live * d * F
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    bound_ms, bound_by = _bound(nbytes, flops, peak)

    leaves = [x.detach().clone().requires_grad_()] + [
        t.detach().clone().requires_grad_() for t in (wg, wu, wd)
        if t is not None]
    sm = slot_map.long()
    xs, *ws = leaves
    u = torch.bmm(xs, ws[-2][sm])
    if act == "swiglu":
        h = torch.nn.functional.silu(torch.bmm(xs, ws[0][sm])) * u
    elif act == "gelu":
        h = torch.nn.functional.gelu(u, approximate="tanh")
    else:
        h = torch.relu(u)
    y = torch.bmm(h, ws[-1][sm])

    def library():
        return torch.autograd.grad(y, leaves, dy, retain_graph=True)
    row = {"max_abs_err": max(errs.values()), "ok": ok,
           "errors": ";".join(f"{k}:{v:.4g}" for k, v in errs.items()),
           "live_rows": n_live, "live_experts": live_experts,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "launches": launches,
           "ms": time_ms(lambda: ops.moe_gemm_bwd(*args), flush, runs=runs),
           "plain_ms": time_ms(lambda: ref.moe_gemm_bwd_plain(*args), flush,
                               runs=3),
           "library_ms": time_ms(library, flush, runs=5)}
    parts, row["profiler_kept"] = device_parts_ms(
        lambda: ops.moe_gemm_bwd(*args), flush, MOE_BWD_PARTS, runs=runs)
    row["profiler_ms"] = sum(parts.values())
    bounds = moe_bwd_part_bounds(n_live, live_experts, S, T, d, F, E, act,
                                 elem, peak, counts.numel())
    row["parts"] = {k: {"ms": parts[k], "bound_ms": bounds[k][0],
                        "bound_by": bounds[k][1]} for k in parts}
    for k, v in parts.items():
        row[f"{k}_ms"] = v
        row[f"{k}_bound_ms"] = bounds[k][0]
    row["device_tflops"] = flops / row["profiler_ms"] / 1e9
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    del y, h, u, leaves
    return row


def moe_gemm_bwd_phase(flush: torch.Tensor, seed: int, cfg):
    """``moe_gemm_bwd`` at the EP train step's layer (``train``: 8 slots x
    4 x 160 rows with the packer's counts, d 4096, F 14336, bf16 swiglu),
    the serving layout (``dup``: 12 slots naming 8 experts, 4 x 112 rows),
    the train layout with garbage in every dead row of x and dy (``dead``),
    gelu and relu at ``MOE_BWD_REDUCED`` widths, and fp32 swiglu there too,
    then the train layer at ``MOE_BWD_MODELS``' widths (swiglu at F 688,
    relu at d 768 / F 3072); every case held against the plain version
    and timed. The train phase
    adds the case of a real EP train step's layer-0 inputs."""
    from repro_torch.kernels import ref

    E, d, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    rows = {}

    def run(key, x, counts, slot_map, w, act, garbage=False):
        dy = (torch.randn(x.shape, generator=gen, device="cuda")
              * 0.1).to(x.dtype)
        if garbage:
            dead = ~ref.live_rows_mask(counts, x.shape[1])[..., None]
            x = x.masked_fill(dead, 3e4)
            dy = dy.masked_fill(dead, -3e4)
        row = moe_bwd_case(x, w["w_gate"] if act == "swiglu" else None,
                           w["w_up"], w["w_down"], slot_map, dy, act, counts,
                           flush)
        rows[key] = row
        S, T, dd = x.shape
        _log_row("moe_gemm_bwd", key,
                 f"S{S}xT{T}xd{dd}xF{w['w_up'].shape[-1]}/{act}", row)

    w = _moe_bwd_weights(gen, E, d, F, torch.bfloat16)
    x, counts, sm = ep_train_layer(cfg, gen, 0)
    live = ref.live_rows_mask(counts, x.shape[1])
    run("bfloat16/train", x, counts, sm, w, "swiglu")
    run("bfloat16/dead", x, counts, sm, w, "swiglu", garbage=True)
    x, counts_dup, sm_dup = ep_train_layer(cfg, gen, DUP_SLOTS)
    run("bfloat16/dup", x, counts_dup, sm_dup, w, "swiglu")
    del w, x
    rd, rf = MOE_BWD_REDUCED["d"], MOE_BWD_REDUCED["F"]
    for dtype, acts in ((torch.bfloat16, ("gelu", "relu")),
                        (torch.float32, ("swiglu",))):
        w = _moe_bwd_weights(gen, E, rd, rf, dtype)
        xr = torch.randn((len(sm), live.shape[1], rd), generator=gen,
                         device="cuda").to(dtype) * live[..., None]
        for act in acts:
            run(f"{str(dtype).split('.')[-1]}/{act}", xr, counts, sm, w, act)
        del w, xr
    torch.cuda.empty_cache()
    from repro_torch.configs.registry import get_config
    for label, arch in MOE_BWD_MODELS.items():
        mc = get_config(arch)
        w = _moe_bwd_weights(gen, mc.moe.num_experts, mc.d_model,
                             mc.moe.d_ff_expert, torch.bfloat16)
        x, counts_m, sm_m = ep_train_layer(mc, gen, 0)
        run(f"bfloat16/{label}", x, counts_m, sm_m, w, mc.activation)
        del w, x
        torch.cuda.empty_cache()
    row = _kernel_row("moe_gemm_bwd",
                      "src/repro_torch/kernels/csrc/moe_gemm_bwd.cu",
                      "src/repro/kernels/moe_gemm.py:60", rows,
                      "bfloat16/train")
    row["gradient_of"] = "moe_gemm"
    row["parts"] = rows["bfloat16/train"]["parts"]
    return row


def _scan_bwd_inputs(gen, B, S, D):
    a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.49 + 0.5
    b = torch.randn((B, S, D), generator=gen, device="cuda") * 0.1
    h0 = torch.randn((B, D), generator=gen, device="cuda")
    return a, b, h0


def _scan_bwd_check(a, h_all, h0, grads):
    """One backward launch held against the plain version: all three
    outputs bit for bit."""
    from repro_torch.kernels import ops, ref

    got = ops.rg_lru_scan_bwd(a, h_all, h0, *grads)
    torch.cuda.synchronize()
    want = ref.rg_lru_scan_bwd_plain(a, h_all, h0, *grads)
    return {"max_abs_err": max(float((g - w).abs().max())
                               for g, w in zip(got, want)),
            "ok": all(torch.equal(g, w) for g, w in zip(got, want))}


def _scan_bwd_bound(B, S, D):
    # a, h_all and d_h_all read, d_a and d_b written; h0 and d_h_last read,
    # d_h0 written; a product, a sum and a product per element
    return _bound(4 * (5 * B * S * D + 3 * B * D), 3 * B * S * D, FP32_FLOPS)


def _scan_bwd_timed(a, h_all, h0, grads, flush):
    from repro_torch.kernels import ops, ref

    return dict(
        ms=time_ms(lambda: ops.rg_lru_scan_bwd(a, h_all, h0, *grads), flush),
        profiler_ms=device_ms(lambda: ops.rg_lru_scan_bwd(
            a, h_all, h0, *grads), flush, ("rg_lru_scan_bwd",)),
        plain_ms=time_ms(lambda: ref.rg_lru_scan_bwd_plain(
            a, h_all, h0, *grads), flush, runs=5),
        library_ms=None)


def rg_lru_bwd_phase(flush: torch.Tensor, seed: int):
    """``rg_lru_scan_bwd`` at the training path's shape (2 x 1024 x 2560:
    ``--batch 2 --seq 1024``) and the scan phase's prefill shape (8 x 3072 x
    2560), both gradients present, timed (events, profiler, plain); then
    untimed one step, a ragged shape, each gradient alone and the ring's
    edges (``SCAN_EDGE_CASES``; each gradient alone past it). Every output
    must equal the plain version bit for bit. No PyTorch call computes the
    recurrence's gradient, so there is no library time. The train phase adds
    the case of a real train step's layer-0 inputs."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    rows = {}
    cases = {"train": (*SCAN_TRAIN, SCAN_D, (True, True), True),
             "prefill": (8, 3072, SCAN_D, (True, True), True),
             "one_step": (8, 1, SCAN_D, (True, True), False),
             "ragged": (2, 1025, 257, (True, True), False),
             "h_all_only": (*SCAN_TRAIN, SCAN_D, (True, False), False),
             "h_last_only": (2, 1025, 257, (False, True), False)}
    cases.update((k, (B, S, D, (True, True), False))
                 for k, (B, S, D, _) in SCAN_EDGE_CASES.items())
    # each gradient alone past the ring, on the TMA path
    B, S, D, _ = SCAN_EDGE_CASES["s_past_ring"]
    cases["h_all_only_long"] = (B, S, D, (True, False), False)
    cases["h_last_only_long"] = (B, S, D, (False, True), False)
    for name, (B, S, D, use, timed) in cases.items():
        a, b, h0 = _scan_bwd_inputs(gen, B, S, D)
        h_all, _ = ops.rg_lru_scan(a, b, h0)
        grads = [torch.randn(s, generator=gen, device="cuda") if u else None
                 for s, u in zip(((B, S, D), (B, D)), use)]
        if name == "misaligned":
            a, h_all, h0 = _off16(a), _off16(h_all), _off16(h0)
            grads = [_off16(g) for g in grads]
        row = _scan_bwd_check(a, h_all, h0, grads)
        if timed:
            row["bound_ms"], row["bound_by"] = _scan_bwd_bound(B, S, D)
            row.update(_scan_bwd_timed(a, h_all, h0, grads, flush))
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        _log_row("rg_lru_scan_bwd", name, f"B{B}xS{S}xD{D}", row)
        del a, b, h0, h_all, grads
    torch.cuda.empty_cache()
    row = _kernel_row("rg_lru_scan_bwd", "src/repro_torch/kernels/csrc/rg_lru.cu",
                      "src/repro/kernels/rg_lru.py:49", rows, "train")
    row["gradient_of"] = "rg_lru_scan"
    return row


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def layer_view(model, cfg, num_layers: int):
    """A Transformer over the first ``num_layers`` layers of ``model``,
    sharing its weight tensors (nothing is copied)."""
    from repro_torch.models.transformer import Transformer

    top = {n: getattr(model, n) for n in ("embed", "final_norm", "lm_head")}
    layers = [dict(layer.named_parameters())
              for layer in model.layers[:num_layers]]
    return Transformer(dataclasses.replace(cfg, num_layers=num_layers), top,
                       layers)


MAIN_CCFG = dict(max_slots=8, prefill_len=512, block_size=16, max_len=1024,
                 strategy="dist_only", predict_interval=4,
                 dup_slots=DUP_SLOTS)


def count_quota_forwards(eng):
    """Count the engine's prefills and decode steps that run with a
    reschedule quota (each EP layer of them runs a rescue round). Returns
    the live {"prefill": n, "decode": n} counts."""
    counts = {"prefill": 0, "decode": 0}
    for kind in counts:
        def counted(*a, _fn=getattr(eng, f"_{kind}_fn"), _kind=kind, **kw):
            counts[_kind] += kw.get("resched") is not None
            return _fn(*a, **kw)
        setattr(eng, f"_{kind}_fn", counted)
    return counts


MAIN_TRACE = dict(requests=16, prompt=(64, 501), new_tokens=64, gap=0.02)


def serve_trace(label: str, model, cfg, seed: int, *, ep: bool,
                phase: str = "main", predictor=None, on_start=None,
                lever: str = "duplicate", resched_impl: str = "greedy",
                ccfg=None, trace=None, strategy=None, capture=None):
    """Serve the main trace (16 requests of 64..500 prompt tokens, 64 new
    tokens each, 20 ms apart) with every kernel count set to 0 just
    before and read just after, at the engine's defaults (under EP: the
    replica store, overlapped migration, ``prefetch_lead`` 2, the
    migration gate); with a ``predictor``, under ``token_to_expert`` (each
    EP prefill layer then runs two dispatch rounds); under ``lever``
    "reschedule" or "both", with ``resched_impl``'s quotas (each EP layer
    then runs a rescue round). ``on_start``: called with the engine just
    before the trace starts. ``ccfg`` / ``trace``: the engine's config and the trace's
    shape in place of ``MAIN_CCFG`` / ``MAIN_TRACE``; ``strategy``: in
    place of dist_only (under "none" nothing re-plans, so no replica is
    required); ``capture``: a ``_PrefillCapture`` armed for the run.
    Returns (engine, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   ServeRequest)

    strategy = strategy or ("token_to_expert" if predictor is not None
                            else "dist_only")
    trace = trace or MAIN_TRACE
    eng = ContinuousEngine(cfg, model, ContinuousConfig(
        **dict(ccfg or MAIN_CCFG, strategy=strategy, lever=lever,
               resched_impl=resched_impl)), ep_ranks=EP_RANKS, ep=ep,
        predictor=predictor)
    quota_forwards = count_quota_forwards(eng)
    if eng._store is not None:
        store = eng._store
        home = cfg.num_layers * cfg.moe.num_experts * store.entry_bytes
        log(phase, path=label, strategy=strategy, replica_impl=cfg.moe.replica_impl,
            overlap=eng._overlap, prefetch_lead=eng.ccfg.prefetch_lead,
            migration_gate=eng.ccfg.migration_gate,
            entry_bytes=store.entry_bytes,
            store_device_gb=f"{store.device_bytes / 1e9:.3f}",
            store_replica_rows_gb=f"{(store.device_bytes - home) / 1e9:.3f}",
            jax_hbm_gb_per_rank=f"{store.hbm_bytes_per_rank / 1e9:.3f}",
            allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    t0 = time.perf_counter()
    eng.warmup()
    log(phase, path=label, warmup_s=f"{time.perf_counter() - t0:.3f}")

    rng = np.random.default_rng(seed)
    reqs = [ServeRequest(rid=i,
                         tokens=rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(*trace["prompt"]))
                                             ).astype(np.int32),
                         max_new_tokens=trace["new_tokens"],
                         arrival=trace["gap"] * i)
            for i in range(trace["requests"])]
    torch.cuda.reset_peak_memory_stats()
    if on_start is not None:
        on_start(eng)
    quota_forwards.update(prefill=0, decode=0)
    ops.reset_launches()
    if capture is not None:
        capture.armed = True
    t0 = time.perf_counter()
    eng.run_trace(reqs)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if capture is not None:
        capture.armed = False

    done = eng.scheduler.completed
    s = eng.metrics.summary()
    imb = eng.metrics.imbalance_over_time()
    prefills = len(reqs) + int(s["preemptions"])   # a preempted one refills
    MEASURED[f"serve/{label}"] = numbers = {
        "step_p50_ms": s["step_p50_s"] * 1e3,
        "ttft_p50_ms": s["ttft_p50"] * 1e3,
        "decode_toks_per_s": s.get("decode_toks_per_s", 0.0),
        "dropped_pairs": int(s["dropped_tokens"]),
        "overflow_pairs": int(s["overflow_tokens"]),
        "overflow_absorbed_frac": s["overflow_absorbed_frac"],
        "measured_imbalance": eng.measured_imbalance() if ep else None,
        "modelled_imbalance": float(np.mean(imb)) if imb else 1.0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(phase, path=label, layers=cfg.num_layers, requests=len(reqs),
        completed=len(done), iterations=eng.iterations,
        prefills=prefills, decode_steps=eng.decode_steps,
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        wall_s=f"{wall:.3f}",
        decode_toks_per_s=f"{s.get('decode_toks_per_s', 0.0):.2f}",
        step_p50_ms=f"{numbers['step_p50_ms']:.3f}",
        ttft_p50_ms=f"{numbers['ttft_p50_ms']:.3f}",
        replans=int(s["replans"]),
        replicated_replans=int(s["replicated_replans"]),
        dropped_pairs=numbers["dropped_pairs"],
        modelled_imbalance=f"{numbers['modelled_imbalance']:.4f}",
        measured_imbalance=(f"{numbers['measured_imbalance']:.4f}" if ep
                            else "n/a (dense path)"),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    eb = max(eng._entry_bytes, 1)
    log(phase, path=label, migration_replans=int(s["migration_replans"]),
        commits=int(s["migration_commits"]),
        rejected=int(s["migration_rejected"]),
        prebegun=int(s["migration_prebegun"]),
        cancelled=int(s["migration_cancelled"]),
        entries_planned=int(s["migration_planned_bytes"] // eb),
        entries_moved=int(s["migration_bytes_moved"] // eb),
        planned_gb=f"{s['migration_planned_bytes'] / 1e9:.3f}",
        moved_gb=f"{s['migration_bytes_moved'] / 1e9:.3f}",
        modelled_stall_ms=f"{s['migration_stall_us'] / 1e3:.3f}",
        modelled_hidden_ms=f"{s['migration_hidden_s'] * 1e3:.3f}",
        modelled_exposed_ms=f"{s['migration_exposed_s'] * 1e3:.3f}",
        stall_model=f"{eng._hw().name} link "
                    f"{eng._hw().link_bw / 1e9:.0f} GB/s, the reference's "
                    "deployment model (no controller: core.simulator."
                    "A100_PCIE), not this card")
    failures = []
    if len(done) != len(reqs):
        failures.append(f"{len(done)} of {len(reqs)} requests completed")
    for r in done:
        toks = np.asarray(r.generated)
        if len(toks) != r.max_new_tokens or (toks < 0).any() \
                or (toks >= cfg.vocab_size).any():
            failures.append(f"request {r.rid}: bad tokens {toks[:8]}...")
    want = expected_launches(launches, cfg, prefills, eng.decode_steps,
                             ep=ep, paged=cfg.paged_attn_impl == "fused",
                             t2e_prefills=prefills if predictor
                             is not None and ep else 0,
                             resched_prefills=quota_forwards["prefill"],
                             resched_decodes=quota_forwards["decode"])
    if launches != want:
        failures.append(f"kernel launches {launches} != {want}")
    if lever != "duplicate" and ep and (
            quota_forwards["prefill"] != prefills
            or quota_forwards["decode"] != eng.decode_steps):
        failures.append(f"forwards with a quota {quota_forwards} != "
                        f"{prefills} prefills, {eng.decode_steps} decodes")
    # "reschedule" freezes the warmup's identity plan: only the
    # prefetcher's pre-begun fills, if the gate lets one through, move it;
    # "none" never re-plans
    duplicating = lever != "reschedule" and strategy != "none"
    if s["replicated_replans"] < 1 and duplicating:
        failures.append("no re-plan replicated an expert")
    if ep:
        e_loc = cfg.moe.num_experts // EP_RANKS
        sc = eng.slot_counts.reshape(cfg.num_layers, EP_RANKS, -1)
        replica_pairs = int(sc[:, :, e_loc:].sum())
        log(phase, path=label, replica_slot_pairs=replica_pairs,
            home_slot_pairs=int(sc[:, :, :e_loc].sum()))
        if replica_pairs == 0 and duplicating:
            failures.append("no replica slot computed a pair")
    if eng._store is not None:
        if duplicating and (s["migration_commits"] < 1
                            or s["migration_bytes_moved"] <= 0):
            failures.append("no migration committed with bytes moved")
        bad = live_rows_mismatch(eng)
        log(phase, path=label, live_replica_rows_checked=bad[1],
            live_rows_equal_home=not bad[0])
        if bad[0]:
            failures.append(f"live replica rows differ from their experts' "
                            f"home rows at {bad[0][:4]}")
    if failures:
        raise SystemExit(f"{phase} path ({label}) failed: "
                         + "; ".join(failures))
    return eng, launches


def expected_launches(launches, cfg, prefills: int, decode_steps: int, *,
                      ep: bool, t2e_prefills: int = 0,
                      resched_prefills: int = 0, resched_decodes: int = 0,
                      paged: bool = True):
    """Each kernel's launches for a run of ``prefills`` prefills (of which
    ``t2e_prefills`` dispatch on Token-to-Expert predictions: two rounds,
    so two ``moe_gemm`` and two ``histogram_offsets`` launches per layer)
    and ``decode_steps`` decode steps of ``cfg.num_layers`` layers. Of
    them ``resched_prefills`` and ``resched_decodes`` ran with a reschedule
    quota: a rescue round per layer (one more ``moe_gemm`` and
    ``histogram_offsets``), and in decode the global first-come positions
    (one more ``histogram_offsets``), whether or not a pair overflowed.
    ``paged``: decode attends over the paged pool through the kernel
    (``ContinuousEngine`` under ``paged_attn_impl="fused"``; "gather" and
    ``ServeEngine``'s linear cache launch no attention kernel). A model
    without MoE launches paged attention only."""
    L = cfg.num_layers
    forwards = (prefills + decode_steps) * L
    want = {k: 0 for k in launches}
    want.update(paged_decode_attention=decode_steps * L if paged else 0,
                fused_topk_route=forwards if cfg.is_moe else 0)
    if ep:
        rescue = (t2e_prefills + resched_prefills + resched_decodes) * L
        want.update(moe_gemm=forwards + rescue,
                    histogram_offsets=forwards + rescue + resched_decodes * L)
    return want


def live_rows_mismatch(eng):
    """([(layer, slot)] whose live replica row is not bit-equal to the home
    row of the slot's expert, number of live replica rows checked)."""
    store = eng._store
    torch.cuda.synchronize()
    rows = store.slot_rows()
    bad, n = [], 0
    for l in range(store.slot_experts.shape[0]):
        for slot in store.replica_slots():
            e = int(store.slot_experts[l, slot])
            if e < 0:
                continue
            n += 1
            if not all(torch.equal(w[l][rows[l, slot]], w[l][e])
                       for w in store.weights.values()):
                bad.append((l, int(slot)))
    return bad, n


def shifted_plan(eng, shift: int):
    """A plan stack that fills every replica slot of every layer: Algorithm
    1 on a distribution whose expert ``(shift + layer) % E`` takes 65% of
    the pairs (it gets the most copies, another expert the rest), so that
    two shifts differ in every replica slot."""
    from repro_torch.core.duplication import duplicate_experts_host
    from repro_torch.core.placement import stack_plans

    m = eng.moe_cfg
    plans = []
    for l in range(eng.cfg.num_layers):
        dist = np.full((m.num_experts,), 0.35 / (m.num_experts - 1))
        dist[(shift + l) % m.num_experts] = 0.65
        plans.append(duplicate_experts_host(
            dist, EP_RANKS, m.duplication_slots, m.max_copies).plan)
    return stack_plans(plans)


def begin_fill(eng, target):
    """Start a layer-staged fill from the plan in force toward ``target``
    through the engine's own executor. Returns the diff."""
    from repro_torch.runtime import plan_diff

    if eng._executor.active:
        eng._executor.cancel()
    diff = plan_diff(eng._plan_stack, target, EP_RANKS,
                     eng.moe_cfg.duplication_slots)
    eng._begin_migration(diff, target)
    return diff


def mixed_plan(live, target, ready):
    """The plan a staged fill serves: ``target``'s layers where ``ready``,
    ``live``'s elsewhere."""
    from repro_torch.core.placement import PlacementPlan

    return PlacementPlan(*(np.where(
        ready.reshape((-1,) + (1,) * (np.asarray(a).ndim - 1)), b, a)
        for a, b in zip(live, target)))


def decode_forward(eng, cfg, seed: int):
    """``forward(plan_dev, store)``: one EP decode forward of 8 slots at
    length 0 in a fresh block pool, the same random tokens on every call.
    Returns the fp32 logits and the slot counts, without synchronising."""
    from repro_torch.serve.kvcache import init_block_pool
    from repro_torch.train.steps import make_paged_decode_step

    decode = make_paged_decode_step(eng.cfg, eng.rt)
    B = eng.ccfg.max_slots
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    tables = torch.arange(1, B + 1, dtype=torch.int32,
                          device="cuda")[:, None].contiguous()
    lengths = torch.zeros((B,), dtype=torch.int32, device="cuda")
    active = torch.ones((B, 1), device="cuda")

    def forward(plan, store):
        pool = init_block_pool(eng.cfg, 1 + B, eng.ccfg.block_size,
                               device="cuda")
        _, lg, _, st = decode(eng.model, tokens, pool, tables, lengths,
                              active, plan, store)
        return lg.float(), st["slot_counts"]
    return forward


def tick_to_mid_state(eng, diff) -> np.ndarray:
    """Enqueue a staged fill a chunk at a time until some layer is ready.
    Returns the ready mask."""
    while not eng._executor.ready_mask().any():  # chunks: a layer prefix
        commit, _ = eng._executor.tick(1)
        if commit is not None:
            raise SystemExit(f"the {diff.num_entries}-entry fill committed "
                             "before a mid-migration state")
    return eng._executor.ready_mask()


def mid_migration_phase(eng, cfg, seed: int) -> None:
    """One EP decode forward (8 slots at length 0 in a fresh block pool)
    at a state of a staged fill with some but not all layers ready, through
    the store view, against the ``replica_impl="gather"`` forward (the
    home rows, through the slot -> expert map) under the per-layer mixed
    plan. Logits and slot counts must be equal bit for bit."""
    target = shifted_plan(eng, 1)
    diff = begin_fill(eng, target)
    ready = tick_to_mid_state(eng, diff)
    mixed = mixed_plan(eng._plan_stack, target, ready)
    forward = decode_forward(eng, cfg, seed)
    out = {"store": forward(eng._plan_dev, eng._store_view()),
           "gather": forward(eng._to_device(mixed), None)}
    torch.cuda.synchronize()
    err = float((out["store"][0] - out["gather"][0]).abs().max())
    equal = (torch.equal(out["store"][0], out["gather"][0])
             and torch.equal(out["store"][1], out["gather"][1]))
    e_loc = cfg.moe.num_experts // EP_RANKS
    sc = out["store"][1].reshape(cfg.num_layers, EP_RANKS, -1)
    ready_rep = int(sc[torch.tensor(ready, device="cuda")][:, :, e_loc:]
                    .sum())
    log("mid_migration", entries=diff.num_entries,
        ready_layers=int(ready.sum()), layers=cfg.num_layers,
        replica_pairs_in_ready_layers=ready_rep,
        max_abs_logit_diff=f"{err:.6g}", bit_equal=equal,
        tolerance="exact (logits and slot_counts)")
    eng._executor.cancel()
    if not 0 < ready.sum() < cfg.num_layers or ready_rep == 0:
        raise SystemExit(f"mid-migration state has {int(ready.sum())} of "
                         f"{cfg.num_layers} layers ready, {ready_rep} pairs "
                         "on their replica slots")
    if not equal:
        raise SystemExit("the store forward mid-migration differs from the "
                         "gather forward under the mixed plan")


def _fill_slots(eng, cfg, seed: int, new_tokens: int, now: float,
                prompt: int = 256) -> float:
    """Admit one fresh ``prompt``-token request per slot and run the
    prefills."""
    from repro_torch.serve import ServeRequest

    rng = np.random.default_rng(seed)
    for i in range(eng.ccfg.max_slots):
        eng.submit(ServeRequest(
            rid=10_000 * (seed % 7 + 1) + i, max_new_tokens=new_tokens,
            arrival=now,
            tokens=rng.integers(0, cfg.vocab_size, prompt).astype(np.int32)))
    while eng.scheduler.waiting:                  # admission + prefills
        eng.step(now)
        now += 1.0
    return now


def _drain(eng, now: float) -> float:
    while eng.has_work():
        eng.step(now)
        now += 1.0
    return now


def _is_copy(name: str) -> bool:
    """A device-to-device copy (the store's row copies are ``copy_`` of
    contiguous rows, a DtoD memcpy each)."""
    return "Memcpy DtoD" in name


def profile_phase(eng, cfg, seed: int, label: str, iters: int = 12,
                  prompt: int = 256) -> None:
    """Where an engine's decode step's time goes: fill every slot with fresh
    requests of ``prompt`` tokens, time ``iters`` decode-only iterations on
    the host clock, then
    ``iters`` more under torch.profiler. Prints the device's busy time by
    kernel and its idle share of the profiled window. Re-planning is off
    (strategy "none"), so the plan in force stays and nothing migrates.
    A session the tracer kept empty is taken again on slots drained and
    filled anew (``profiled``)."""
    strategy, eng.strategy = eng.strategy, "none"
    in_flight = eng._executor is not None and eng._executor.active
    now = _fill_slots(eng, cfg, seed + 1, 2 * iters + 8, 0.0, prompt)
    t0 = time.perf_counter()
    for _ in range(iters):
        eng.step(now)
        now += 1.0
    plain_ms = (time.perf_counter() - t0) * 1e3 / iters
    refills = iter(range(2, PROFILE_SESSIONS + 1))

    def steps():
        nonlocal now
        t0 = time.perf_counter()
        for _ in range(iters):
            eng.step(now)
            now += 1.0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    def refill():
        nonlocal now
        now = _fill_slots(eng, cfg, seed + next(refills), iters + 8,
                          _drain(eng, now), prompt)

    prof, wall_ms = profiled(steps, f"the {label} decode step", cpu=True,
                             again=refill)
    _drain(eng, now)
    eng.strategy = strategy
    kernels = {} if prof is None else _kernel_time_by_name(prof, iters)
    busy = sum(ms for ms, _ in kernels.values()) if kernels else NOT_MEASURED
    MEASURED[f"profile/{label}"] = {"step_ms": plain_ms, "busy_ms": busy,
                                    "profiled_step_ms": wall_ms}
    log("profile", path=label, decode_iterations=iters,
        slots=eng.ccfg.max_slots, fill_in_flight_at_start=in_flight,
        dtod_copies_per_step=sum(n for name, (_, n) in kernels.items()
                                 if _is_copy(name)) / iters,
        step_ms=f"{plain_ms:.3f}", profiled_step_ms=f"{wall_ms:.3f}",
        device_busy_ms_per_step=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall_ms:.4f}",
        device_ops_per_step=f"{sum(n for _, n in kernels.values()) / iters:.1f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        log("profile", path=label, ms_per_step=f"{ms:.4f}",
            share=f"{ms / busy:.4f}", per_step=f"{n / iters:.1f}",
            kernel=f"'{name[:90]}'")
    for kname, names in (
            ("paged_decode_attention (split + combine)", PAGED_KERNELS),
            ("moe_gemm (gate/up + down)", ("moe_gemm",)),
            ("fused_topk_route", ("topk_route",)),
            ("histogram_offsets", ("histogram_offsets",))):
        hits = [(ms, n) for name, (ms, n) in kernels.items()
                if any(k in name for k in names)]
        log("profile", path=label, kernel=kname,
            ms_per_step=f"{sum(ms for ms, _ in hits):.4f}",
            launches_per_step=f"{sum(n for _, n in hits) / iters:.1f}")


FILL_RANGE = "chip_smoke.fill_steps"


def migration_profile_phase(eng, cfg, seed: int, max_steps: int = 8) -> None:
    """Decode steps during which a staged fill is in flight: every slot
    busy, a fill toward ``shifted_plan`` begun, then decode iterations under
    torch.profiler until it commits. Prints the copies' device time per
    entry (three row copies each) and their rate, the main stream's busy
    time per step beside them, and the reference's modelled stall for the
    same entries (an A100-PCIe link, not this card). A session in which
    the tracer kept none, or only some, of the fill's copies (one commit,
    no other side-stream event) is taken again, at most
    ``PROFILE_SESSIONS``: slots filled anew and a fill toward the next
    shift."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    from repro_torch.runtime import migration_stall_s

    strategy, eng.strategy = eng.strategy, "none"
    now = 0.0
    for session in range(PROFILE_SESSIONS):
        now = _fill_slots(eng, cfg, seed + 2 + session, max_steps + 8, now)
        for _ in range(2):                        # decode-only windows
            eng.step(now)
            now += 1.0
        commits = eng.metrics.migration["commits"]
        steps = 0
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            # a step before the fill: the tracer can miss the first device
            # events of a window, and only events after its end are counted
            eng.step(now)
            now += 1.0
            torch.cuda.synchronize()
            with record_function(FILL_RANGE):
                diff = begin_fill(eng, shifted_plan(eng, 2 + session))
                t0 = time.perf_counter()
                while eng._executor.active and steps < max_steps:
                    eng.step(now)
                    now += 1.0
                    steps += 1
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
        committed = eng.metrics.migration["commits"] - commits
        now = _drain(eng, now)
        start = next((e.time_range.start for e in prof.events()
                      if e.name == FILL_RANGE), None)
        by_stream = {} if start is None else _events_by_stream(prof, start)
        busy = {res: sum(ms for _, ms in evs)
                for res, evs in by_stream.items()}
        main = max(busy, key=busy.get, default=None)   # the forward's stream
        side = [(name, ms) for res, evs in by_stream.items() if res != main
                for name, ms in evs]
        copies = [ms for name, ms in side if _is_copy(name)]
        n = diff.num_entries
        if by_stream and not (committed == 1 and len(copies) < 3 * n
                              and len(side) == len(copies)):
            break
        log("profile", retry=f"session {session + 1} of {PROFILE_SESSIONS} "
            f"kept {len(copies)} of the fill's {3 * n} copies and "
            f"{sum(map(len, by_stream.values()))} device events in its window")
    eng.strategy = strategy
    if not by_stream:
        raise SystemExit(f"migration profile: {PROFILE_SESSIONS} profiler "
                         "sessions kept no device event of the fill")
    copy_ms = sum(copies)
    eb = eng._store.entry_bytes
    per_step = max(steps, 1)
    for res in sorted(busy):
        log("migration_profile", stream=res, main=res == main,
            events=len(by_stream[res]),
            busy_ms_per_step=f"{busy[res] / per_step:.3f}")
    log("migration_profile", entries=n, entry_bytes=eb, steps=steps,
        committed=int(committed), side_stream_copies=len(copies),
        side_stream_other_events=len(side) - len(copies),
        copy_ms_per_entry=f"{copy_ms / max(n, 1):.4f}",
        copy_gb_per_s=f"{n * eb / max(copy_ms, 1e-9) / 1e6:.1f}",
        copy_read_write_gb_per_s=f"{2 * n * eb / max(copy_ms, 1e-9) / 1e6:.1f}",
        copy_ms_per_step=f"{copy_ms / per_step:.3f}",
        main_stream_busy_ms_per_step=f"{busy[main] / per_step:.3f}",
        profiled_step_ms=f"{wall_ms:.3f}",
        modelled_stall_ms=f"{migration_stall_s(n * eb, eng._hw()) * 1e3:.3f}",
        stall_model="A100-PCIe 64 GB/s (reference's deployment model)")
    if committed != 1 or len(copies) != 3 * n or len(side) != len(copies):
        raise SystemExit(f"migration profile: {int(committed)} commits, "
                         f"{len(copies)} side-stream copies for {n} entries, "
                         f"{len(side) - len(copies)} other side-stream events")


def build_mixtral(seed: int, layers: int = MAIN_LAYERS,
                  phase: str = "main", dup_slots: int = DUP_SLOTS):
    """Mixtral-8x7B at published widths, the first ``layers`` of its 32
    layers, random weights from ``seed``, on the card. ``init_model`` draws
    the embedding, the head, then the layers in order, so a smaller
    ``layers`` gives the first layers of a larger model's weights."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=layers)
    log(phase, model=cfg.name, d_model=cfg.d_model, heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        d_ff_expert=cfg.moe.d_ff_expert, vocab=cfg.vocab_size,
        window=cfg.sliding_window, ep_ranks=EP_RANKS, dup_slots=dup_slots,
        capacity_factor=cfg.moe.capacity_factor,
        reduced=f"num_layers 32->{layers} (32 bf16 layers ~93 GB > 80 GB)"
                + (f"; the dense path's run {DENSE_LAYERS} of them"
                   if phase == "main" else ""))
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    log(phase, init_s=f"{time.perf_counter() - t0:.3f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    return model, cfg


def main_path_phase(model, cfg, seed: int):
    from repro_torch.serve import ContinuousConfig, ContinuousEngine

    dense = layer_view(model, cfg, DENSE_LAYERS)
    eng, _ = serve_trace("dense", dense, dense.cfg, seed, ep=False)
    del eng, dense
    # the store run: the engine's defaults (replica_impl "store")
    eng, launches = serve_trace("ep", model, cfg, seed, ep=True)
    mid_migration_phase(eng, cfg, seed)
    profile_phase(eng, cfg, seed, "store")
    gather_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, replica_impl="gather"))
    gather = ContinuousEngine(gather_cfg, model,
                              ContinuousConfig(**MAIN_CCFG),
                              ep_ranks=EP_RANKS, ep=True)
    gather._set_plan(eng._plan_stack)             # the store run's plan
    profile_phase(gather, cfg, seed, "gather")
    del gather
    migration_profile_phase(eng, cfg, seed)
    del eng                                       # and its replica rows
    torch.cuda.empty_cache()
    return launches


# The GPS loop's run: the shapes of the JAX package's
# benchmarks/bench_serve_traces.py, its trace and its time scale.
GPS_CCFG = dict(max_slots=8, prefill_len=64, block_size=16, max_len=96,
                strategy="dist_only", predict_interval=4,
                dup_slots=DUP_SLOTS, metrics_window=8)
GPS_TRACE = dict(horizon=90.0, rate=1.5)
GPS_TIME_SCALE = 20.0
# The saving MoE-GPS must predict before balancing is run: between the
# flat windows' predicted dist_only savings (skew 1.48-1.86: 0.27-0.36) and
# the hot windows' (skew 2.54-3.74: 0.50-0.65) on the H100 preset, from
# the window skews of this phase's first run on the card (PERF.md).
GPS_MIN_SAVING = 0.45


def audit_mismatches(ctl):
    """Sequence numbers of the controller's audit records whose inputs
    ``recommend_strategy`` replays to another verdict (or lever). The
    replica weight reads a controller with several levers charges are 0
    here: the full model's config has no replica slots."""
    from repro_torch.core.gps import recommend_strategy

    c = ctl.cfg
    bad = []
    for r in ctl.audit.records:
        v, _ = recommend_strategy(
            ctl.model_cfg, c.hardware, skew=r.skew_input, batch=r.batch,
            seq=r.seq_len, allow_t2e=r.allow_t2e, min_saving=r.min_saving,
            migration_stall_s=r.migration_stall_s, levers=c.levers,
            resched_residual=r.resched_residual,
            resched_extra_frac=r.resched_extra_frac)
        if (str(v), v.lever) != (r.recommended, r.lever_recommended):
            bad.append(r.seq)
    return bad


def restart_check(eng, cfg, seed: int) -> None:
    """A staged fill restarted while in flight, as a re-plan restarts it:
    a fill toward plan A is enqueued until some layer is ready, a decode
    forward reading A's filled rows is queued, then a fill toward plan B
    (every replica slot different, so its copies overwrite the rows the
    first forward reads) begins from the plan in force and is enqueued
    until some layer is ready, and a second forward reads B's rows. Each
    forward must equal, bit for bit, the gather forward under its own
    mixed plan (write after read: B's copies wait for the first forward),
    and the engine's fill target on the device must be B's."""
    from repro_torch.runtime import plan_diff

    forward = decode_forward(eng, cfg, seed)
    live = eng._plan_stack
    outs, mixed, diffs, ready_layers, experts = [], [], [], [], []
    for shift in (1, 2):
        target = shifted_plan(eng, shift)
        diff = plan_diff(live, target, EP_RANKS,
                         eng.moe_cfg.duplication_slots)
        eng._begin_migration(diff, target)        # a restart on shift 2
        ready = tick_to_mid_state(eng, diff)
        outs.append(forward(eng._plan_dev, eng._store_view()))
        mixed.append(mixed_plan(live, target, ready))
        diffs.append(diff)
        experts.append(eng._to_device(target).slot_experts.cpu().numpy())
        ready_layers.append(int(ready.sum()))
    on_device = (None if eng._target_dev is None
                 else eng._target_dev.slot_experts.cpu().numpy())
    target_ok = (on_device is not None
                 and np.array_equal(on_device, experts[1])
                 and not np.array_equal(on_device, experts[0]))
    refs = [forward(eng._to_device(m), None) for m in mixed]
    torch.cuda.synchronize()
    equal = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
             for a, b in zip(outs, refs)]
    eng._cancel_migration()
    log("gps_restart", entries=",".join(str(d.num_entries) for d in diffs),
        ready_layers=",".join(map(str, ready_layers)),
        forward_a_bit_equal=equal[0], forward_b_bit_equal=equal[1],
        target_on_device_is_b=target_ok, in_flight_after_cancel=(
            eng._executor.active or eng._target_dev is not None),
        tolerance="exact (logits and slot_counts)")
    if not (all(equal) and target_ok):
        raise SystemExit("a fill restarted in flight broke a forward or "
                         "left the old target in force")


def gps_phase(model, cfg, seed: int) -> None:
    """The GPS decision loop on the card: the EP engine (store defaults)
    with an ``OnlineGPSController`` on the H100 preset replays the
    skew-shifting trace; checks completions, launches, one decision per
    closed window, the engine following every decision, the audit log
    replayed through ``recommend_strategy``, skew rising from the flat
    start to the hot middle, a switch to "none" and back, and live replica
    rows equal to their experts' home rows; then a fill restarted in
    flight (``restart_check``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.simulator import A100_PCIE, H100_SXM_NVLINK
    from repro_torch.kernels import ops
    from repro_torch.runtime import migration_stall_s
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   ControllerConfig, OnlineGPSController)
    from repro_torch.workloads import skew_shift_trace, to_serve_requests

    full = get_config("mixtral-8x7b")
    ccfg = ControllerConfig(
        hardware=H100_SXM_NVLINK, window_iters=8, patience=1,
        min_saving=GPS_MIN_SAVING,
        # the engine moves 8 layers' rows; the controller prices the
        # 32-layer deployment it simulates
        migration_bytes_scale=full.num_layers / cfg.num_layers)
    ctl = OnlineGPSController(full, ccfg, predictor_available=False)
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**GPS_CCFG),
                           ep_ranks=EP_RANKS, ep=True, controller=ctl)
    hw = ccfg.hardware
    log("gps", model=cfg.name, layers=cfg.num_layers,
        reduced=f"num_layers 32->{MAIN_LAYERS} (the cut of the main run: "
                "32 bf16 layers ~93 GB > 80 GB)",
        engine=",".join(f"{k}:{v}" for k, v in GPS_CCFG.items()),
        replica_impl=cfg.moe.replica_impl, overlap=eng._overlap,
        migration_gate=eng.ccfg.migration_gate,
        hardware=f"'{hw}'", window_iters=ccfg.window_iters,
        patience=ccfg.patience, min_saving=ccfg.min_saving,
        migration_bytes_scale=ccfg.migration_bytes_scale,
        moe_gemm_prefill_tflops=MEASURED.get("moe_gemm_prefill_tflops",
                                             "not measured"),
        mxu_util_measured=(
            f"{MEASURED['moe_gemm_prefill_tflops'] * 1e12 / BF16_FLOPS:.4f}"
            if "moe_gemm_prefill_tflops" in MEASURED else "not measured"))

    # instrumentation: fills restarted or cancelled while in flight, the
    # controller's host time, one decision per closed window, the engine
    # following each decision, the arrival times each window served
    ex = eng._executor
    fills = {"begun": 0, "restarted": 0, "cancelled_in_flight": 0}
    begin, cancel = ex.begin, ex.cancel

    def counted_begin(diff, target):
        fills["begun"] += 1
        fills["restarted"] += ex.active
        begin(diff, target)

    def counted_cancel():
        fills["cancelled_in_flight"] += ex.active
        cancel()
    ex.begin, ex.cancel = counted_begin, counted_cancel
    eval_s = []
    evaluate = ctl._evaluate

    def timed_evaluate(now):
        t0 = time.perf_counter()
        d = evaluate(now)
        eval_s.append(time.perf_counter() - t0)
        return d
    ctl._evaluate = timed_evaluate
    closed, window_errors = [0], []
    observe = ctl.observe

    def checked_observe(counts, now, **kw):
        closes = ctl._iters + 1 >= ccfg.window_iters
        had = ctl._counts is not None or counts is not None
        d = observe(counts, now, **kw)
        closed[0] += closes and had
        if (d is not None) != (closes and had):
            window_errors.append(f"t={now:.2f}: decision {d is not None}, "
                                 f"window closed with counts {closes and had}")
        return d
    ctl.observe = checked_observe
    follow_errors = []
    apply_decision = eng._apply_decision

    def checked_apply(d):
        apply_decision(d)
        if (eng.strategy, eng.predict_interval) != (d.strategy,
                                                    d.predict_interval):
            follow_errors.append(f"t={d.t:.2f}: engine {eng.strategy}/"
                                 f"{eng.predict_interval}, decision "
                                 f"{d.strategy}/{d.predict_interval}")
        if d.strategy == "none" and (
                ex.active or eng._target_dev is not None
                or int(np.asarray(eng._plan_stack.n_replicas).max()) != 1):
            follow_errors.append(f"t={d.t:.2f}: under 'none' a fill is in "
                                 "flight or the plan replicates")
    eng._apply_decision = checked_apply
    arrivals, windows = [], []
    step = eng.step

    def recording_step(now, clock=None):
        ev = step(now, clock)
        arrivals.extend(r.arrival for r in ev.prefilled)
        if ev.decision is not None:
            windows.append((ev.decision,
                            float(np.mean(arrivals)) if arrivals else None))
            arrivals.clear()
        return ev
    eng.step = recording_step

    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    trace = skew_shift_trace(cfg.vocab_size, seed=seed, **GPS_TRACE)
    reqs = to_serve_requests(trace)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    end = eng.run_trace(reqs, time_scale=GPS_TIME_SCALE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    s = eng.metrics.summary()
    imb = eng.metrics.imbalance_over_time()
    done = eng.scheduler.completed
    prefills = len(reqs) + int(s["preemptions"])
    decisions = ctl.decisions
    switches = [d for d in decisions if d.switched]
    log("gps", requests=len(reqs), completed=len(done),
        iterations=eng.iterations, prefills=prefills,
        decode_steps=eng.decode_steps, virtual_end_s=f"{end:.3f}",
        time_scale=GPS_TIME_SCALE, warmup_s=f"{warmup_s:.3f}",
        wall_s=f"{wall:.3f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        decisions=len(decisions), windows_closed_with_counts=closed[0],
        switches=len(switches),
        switch_log=f"'{' | '.join(ctl.switch_log())}'")
    log("gps", **{k: f"{v:g}" for k, v in ctl.audit.summary().items()})
    log("gps", window_skews=",".join(f"{d.skew:.4f}" for d, _ in windows),
        window_mean_arrival_s=",".join(
            "-" if a is None else f"{a:.1f}" for _, a in windows))
    log("gps", verdicts=",".join(str(d.recommended) for d in decisions),
        strategies=",".join(d.strategy for d in decisions),
        predict_interval=",".join(str(d.predict_interval)
                                  for d in decisions),
        dist_only_saving=",".join(
            f"{r.dist_only_saving:.4f}" for r in ctl.audit.records))
    eb = max(eng._entry_bytes, 1)
    planned = s["migration_planned_bytes"]
    log("gps", migration_replans=int(s["migration_replans"]),
        commits=int(s["migration_commits"]),
        rejected=int(s["migration_rejected"]),
        prebegun=int(s["migration_prebegun"]),
        cancelled=int(s["migration_cancelled"]),
        fills_begun=fills["begun"], fills_restarted=fills["restarted"],
        fills_cancelled_in_flight=fills["cancelled_in_flight"],
        entries_planned=int(planned // eb),
        entries_moved=int(s["migration_bytes_moved"] // eb),
        moved_gb=f"{s['migration_bytes_moved'] / 1e9:.3f}",
        modelled_stall_ms=f"{s['migration_stall_us'] / 1e3:.3f}",
        modelled_hidden_ms=f"{s['migration_hidden_s'] * 1e3:.3f}",
        modelled_exposed_ms=f"{s['migration_exposed_s'] * 1e3:.3f}",
        stall_model=f"'{eng._hw().name}' link {eng._hw().link_bw / 1e9:.0f} "
                    "GB/s (modelled, not this card)",
        a100_pcie_stall_ms_same_bytes=(
            f"{migration_stall_s(planned, A100_PCIE) * 1e3:.3f}"))
    ttft = s["ttft_p50"]
    log("gps", step_p50_ms=f"{s['step_p50_s'] * 1e3:.3f}",
        ttft_p50_virtual_s=f"{ttft:.3f}",
        ttft_p50_wall_ms=f"{ttft / GPS_TIME_SCALE * 1e3:.3f}",
        decode_toks_per_s=f"{s.get('decode_toks_per_s', 0.0):.2f}",
        measured_imbalance=f"{eng.measured_imbalance():.4f}",
        modelled_imbalance=f"{float(np.mean(imb)) if imb else 1.0:.4f}",
        dropped_pairs=int(s["dropped_tokens"]),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        controller_eval_ms_p50=f"{np.median(eval_s) * 1e3:.4f}",
        controller_eval_ms_max=f"{max(eval_s) * 1e3:.4f}")

    failures = window_errors[:3] + follow_errors[:3]
    if len(done) != len(reqs):
        failures.append(f"{len(done)} of {len(reqs)} requests completed")
    for r in done:
        toks = np.asarray(r.generated)
        if len(toks) != r.max_new_tokens or (toks < 0).any() \
                or (toks >= cfg.vocab_size).any():
            failures.append(f"request {r.rid}: bad tokens {toks[:8]}...")
    want = expected_launches(launches, cfg, prefills, eng.decode_steps,
                             ep=True)
    if launches != want:
        failures.append(f"kernel launches {launches} != {want}")
    if len(decisions) != closed[0]:
        failures.append(f"{len(decisions)} decisions for {closed[0]} "
                        "windows closed with counts")
    replay_bad = audit_mismatches(ctl)
    log("gps", audit_records=len(ctl.audit), replayed_equal=not replay_bad)
    if replay_bad:
        failures.append(f"audit records {replay_bad[:4]} replay to another "
                        "verdict")
    H = GPS_TRACE["horizon"]
    flat = [d.skew for d, a in windows if a is not None and a < 0.35 * H]
    hot = [d.skew for d, a in windows
           if a is not None and 0.5 * H <= a <= 0.75 * H]
    log("gps", flat_start_skews=",".join(f"{x:.4f}" for x in flat),
        hot_middle_skews=",".join(f"{x:.4f}" for x in hot))
    if not (flat and hot and max(hot) > min(flat)):
        failures.append("no hot-middle window skew above the flat start's "
                        "lowest")
    if not any(d.strategy == "none" for d in switches):
        failures.append("no switch to 'none'")
    if not any(d.strategy == "dist_only" for d in switches):
        failures.append("no switch back to 'dist_only'")
    bad = live_rows_mismatch(eng)
    log("gps", live_replica_rows_checked=bad[1],
        live_rows_equal_home=not bad[0])
    if bad[0]:
        failures.append(f"live replica rows differ from their experts' home "
                        f"rows at {bad[0][:4]}")
    if failures:
        raise SystemExit("GPS loop failed: " + "; ".join(failures))
    restart_check(eng, cfg, seed)
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase t2e: Token-to-Expert prediction on the main path
# ---------------------------------------------------------------------------

# the predictors' training trace: the routing of a predictable synthetic
# corpus over Mixtral's vocabulary, experts and (cut) layers
T2E_FIT_TRACE = dict(num_sequences=256, seq_len=64, skew=1.8,
                     predictability=0.9)
T2E_PROMPT = 512                   # the main path's prefill bucket
T2E_LOGIT_TOL = 1e-3               # card against CPU, fp32 logits
T2E_NEAR_TIE = 1e-4                # top-2 margin of a label allowed to flip
T2E_CTL_TRACE = dict(horizon=45.0, rate=1.5)


def _predict_ms(m, prompt, runs: int):
    """Medians over ``runs`` calls of ``m.predict(prompt)`` (labels back on
    the host): host wall ms and CUDA-event ms."""
    m.predict(prompt)
    host, events = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        m.predict(prompt)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return float(np.median(host)), float(np.median(events))


def _card_vs_cpu(m, tokens: np.ndarray):
    """A neural predictor's logits on the card against the same weights on
    the CPU. Returns (max |difference|, labels differing, of them near
    ties of the CPU logits)."""
    from repro_torch.optim.adamw import tree_map

    vocab = m.params["embed"].shape[0]
    cpu = type(m)(m.num_layers, m.num_experts, vocab, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), m.params)
    with torch.inference_mode():
        a = m.apply(m.params, torch.as_tensor(tokens, device="cuda")).cpu()
        b = cpu.apply(cpu.params, torch.as_tensor(tokens))
    top2 = b.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < T2E_NEAR_TIE
    flips = a.argmax(-1) != b.argmax(-1)
    return (float((a - b).abs().max()), int(flips.sum()),
            int((flips & near).sum()))


def fit_ladder(cfg, seed: int):
    """Fit the four rungs on the synthetic routing trace (80/20 split; the
    neural ones on the card at the JAX defaults), print each one's
    held-out accuracy, FLOPs per token, fit time and per-prompt predict
    time, and hold the FFN and LSTM forwards on the card against the CPU.
    Returns {rung: predictor}."""
    from repro_torch.core.predictors import (ConditionalProbabilityModel,
                                             FFNPredictor, LSTMPredictor,
                                             ProbabilityModel, accuracy)
    from repro_torch.data.synthetic import make_routing_trace

    L, E, V = cfg.num_layers, cfg.moe.num_experts, cfg.vocab_size
    tr = make_routing_trace(vocab=V, num_experts=E, num_layers=L, seed=seed,
                            **T2E_FIT_TRACE)
    n = int(tr.tokens.shape[0] * 0.8)
    tok_tr, ex_tr = tr.tokens[:n], tr.experts[:, :n]
    tok_te, ex_te = tr.tokens[n:], tr.experts[:, n:]
    prompt = np.random.default_rng(seed).integers(
        0, V, (1, T2E_PROMPT)).astype(np.int32)
    makers = {"probability": lambda: ProbabilityModel(L, E),
              "conditional": lambda: ConditionalProbabilityModel(L, E, V),
              "ffn": lambda: FFNPredictor(L, E, V, seed=seed, device="cuda"),
              "lstm": lambda: LSTMPredictor(L, E, V, seed=seed,
                                            device="cuda")}
    rungs, failures = {}, []
    for name, make in makers.items():
        t0 = time.perf_counter()
        m = make().fit(ex_tr, tok_tr)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        acc = accuracy(m.predict(tok_te), ex_te)
        host, event = _predict_ms(m, prompt, 10 if name == "lstm" else 25)
        MEASURED[f"t2e/{name}"] = dict(accuracy=acc, host_ms=host,
                                       event_ms=event)
        extra = {}
        if name in ("ffn", "lstm"):
            checks = [_card_vs_cpu(m, t) for t in (tok_te, prompt)]
            err = max(c[0] for c in checks)
            flips = sum(c[1] for c in checks)
            near = sum(c[2] for c in checks)
            extra = dict(card_vs_cpu_max_abs_err=f"{err:.3g}",
                         label_flips=flips, of_them_near_ties=near,
                         tolerance=f"logits {T2E_LOGIT_TOL}, labels equal "
                                   f"outside top-2 margins < {T2E_NEAR_TIE}")
            if err > T2E_LOGIT_TOL or flips > near:
                failures.append(f"{name} on the card differs from the CPU "
                                f"(max {err:.3g}, {flips - near} label flips "
                                "outside near ties)")
        log("t2e", rung=name, heldout_accuracy=f"{acc:.4f}",
            flops_per_token=m.flops_per_token(L), fit_s=f"{fit_s:.3f}",
            predict_prompt=f"1x{T2E_PROMPT}",
            predict_host_ms_p50=f"{host:.4f}",
            predict_event_ms_p50=f"{event:.4f}", **extra)
        rungs[name] = m
    if not MEASURED["t2e/conditional"]["accuracy"] > \
            MEASURED["t2e/probability"]["accuracy"]:
        failures.append("the conditional model does not beat the global "
                        "frequency model")
    if failures:
        raise SystemExit("t2e predictors failed: " + "; ".join(failures))
    log("t2e", trace="make_routing_trace(" + ", ".join(
        f"{k}={v}" for k, v in T2E_FIT_TRACE.items())
        + f", vocab={V}, num_experts={E}, num_layers={L}, seed={seed})",
        split="80/20", train_sequences=n, heldout_sequences=len(tok_te))
    return rungs


class _RoundCapture:
    """Keeps copies of the second round's ``moe_gemm`` inputs (the second
    ``grouped_ffn`` call) of every EP dispatch given ``key``: with
    ``"predicted_idx"`` the Token-to-Expert correction round, with
    ``"resched_quota"`` the rescue round. The last ``RING`` of each kind
    are kept (prefill: ``ep_moe_ffn``, decode: ``ep_moe_ffn_replicated``)
    without reading anything back during the run. With predictions it
    also counts, on the card (read once at the end), the (token, k) pairs
    of the predicted prefills and those mispredicted (sent to the
    correction round). Installed around ``moe.dispatch``'s two EP
    functions and ``grouped_ffn``; ``reset()`` zeroes the counts."""

    RING = 32

    def __init__(self, key: str):
        from repro_torch.moe import dispatch

        self.key = key
        self.mod = dispatch
        self.real = (dispatch.ep_moe_ffn, dispatch.ep_moe_ffn_replicated,
                     dispatch.grouped_ffn)
        self.kind = None
        self.calls = 0
        self.rings = {"prefill": [], "decode": []}
        self.seen = {"prefill": 0, "decode": 0}
        self.sums = torch.zeros(2, dtype=torch.int64, device="cuda")

    def reset(self):
        self.sums.zero_()

    def _wrap(self, fn, kind):
        def wrapped(x, router_out, *a, **kw):
            if kw.get(self.key) is None:
                return fn(x, router_out, *a, **kw)
            if self.key == "predicted_idx":
                R = x.shape[0]
                pred = kw["predicted_idx"]
                self.sums[0] += pred.numel()
                self.sums[1] += (pred.reshape(R, -1).to(torch.int64)
                                 != router_out.expert_idx.reshape(R, -1)
                                 .to(torch.int64)).sum()
            self.kind, self.calls = kind, 0
            try:
                return fn(x, router_out, *a, **kw)
            finally:
                self.kind = None
        return wrapped

    def __enter__(self):
        real_ep, real_rep, real_ffn = self.real

        def capturing_ffn(experts, x, slot_rows, activation,
                          row_counts=None):
            if self.kind is not None:
                self.calls += 1
                if self.calls == 2:              # the second round
                    i = self.seen[self.kind] % self.RING
                    self.rings[self.kind][i:i + 1] = [(
                        x.clone(), row_counts.clone(), slot_rows.clone(),
                        experts)]
                    self.seen[self.kind] += 1
            return real_ffn(experts, x, slot_rows, activation,
                            row_counts=row_counts)
        self.mod.ep_moe_ffn = self._wrap(real_ep, "prefill")
        self.mod.ep_moe_ffn_replicated = self._wrap(real_rep, "decode")
        self.mod.grouped_ffn = capturing_ffn
        return self

    def __exit__(self, *exc):
        (self.mod.ep_moe_ffn, self.mod.ep_moe_ffn_replicated,
         self.mod.grouped_ffn) = self.real

    def latest(self, kind):
        """The last kept second round of ``kind``."""
        ring = self.rings[kind]
        return ring[(self.seen[kind] - 1) % self.RING] if ring else None

    def busiest(self, kind):
        """The kept second round of ``kind`` with the most live rows."""
        ring = self.rings[kind]
        return max(ring, key=lambda c: int(c[1].sum())) if ring else None

    def numbers(self):
        pairs, sent = self.sums.tolist()
        return dict(prefill_pairs=pairs, sent_to_correction=sent,
                    mispredicted_share=f"{sent / max(pairs, 1):.4f}")


def round_case(label: str, captured) -> None:
    """``moe_gemm`` on a real second round's rows and counts against its
    plain version: the kernels line's ``prefill_correction``,
    ``prefill_rescue`` or ``decode_rescue`` case. A round with no live row
    checks no arithmetic, only the launch and its cost: the log says so
    (``arithmetic_checked``)."""
    x, counts, slot_rows, experts, *act = captured
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    row = moe_gemm_case(x, counts, slot_rows, experts, flush,
                        act[0] if act else "swiglu")
    S, T, d = x.shape
    row["live_rows_per_block"] = ",".join(
        str(c) for c in counts.flatten().tolist())
    row["arithmetic_checked"] = bool(int(counts.sum()) > 0)
    _log_row("moe_gemm", f"bfloat16/{label}",
             f"S{S}xT{T}xd{d}xF{experts['w_up'].shape[-1]}", row)
    if not row["ok"]:
        raise SystemExit(f"moe_gemm disagrees with its plain version at "
                         f"bfloat16/{label}")
    if "moe_gemm" in KERNEL_ROWS:
        k = KERNEL_ROWS["moe_gemm"]
        k["max_abs_err"] = max(k["max_abs_err"], row["max_abs_err"])
    del flush


class _PrefillCapture:
    """Keeps copies of the first ``fused_topk_route``, ``histogram_offsets``
    and ``moe_gemm`` inputs of one EP prefill, taken while ``armed``:
    layer 0's router logits, its first round's packer ids and its first
    round's expert rows and counts (the weights by reference: the model's
    or the store's rows). Nothing is read back during the run. Installed
    around the three wrappers of ``kernels.ops``, which the router and the
    dispatch call through the module."""

    KERNELS = ("fused_topk_route", "histogram_offsets", "moe_gemm")

    def __init__(self):
        from repro_torch.kernels import ops

        self.ops = ops
        self.real = {k: getattr(ops, k) for k in self.KERNELS}
        self.armed = False
        self.inputs = {}

    def _keep(self, name, a, kw):
        if name == "moe_gemm":
            x, w_gate, w_up, w_down, slot_rows = a[:5]
            return (x.clone(), kw["row_counts"].clone(), slot_rows.clone(),
                    {"w_gate": w_gate, "w_up": w_up, "w_down": w_down},
                    a[5] if len(a) > 5 else kw.get("activation", "swiglu"))
        return (a[0].clone(), a[1])          # (logits, K) / (ids, C)

    def _wrap(self, name):
        real = self.real[name]

        def wrapped(*a, **kw):
            if self.armed and name not in self.inputs:
                self.inputs[name] = self._keep(name, a, kw)
            return real(*a, **kw)
        return wrapped

    def __enter__(self):
        for k in self.KERNELS:
            setattr(self.ops, k, self._wrap(k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.ops, k, fn)


def prefill_cases(label: str, cap: _PrefillCapture, prefix: str = "serve_ep",
                  max_slots: int = 0) -> None:
    """The three kernels on one real EP prefill's inputs
    (``_PrefillCapture``) against their plain versions, at the kernel
    phases' tolerances: ``_route_check`` (no planted tie rows),
    ``_hist_check`` and ``moe_gemm_case`` (``round_case``). Logs each row
    as the kernels line's ``<prefix>_<label>`` case; a mismatch fails the
    phase. ``max_slots``: hold ``moe_gemm`` on the first that many slots
    only (the plain version gathers every slot's weights: at arctic's
    widths 70 MB a matrix)."""
    case = f"{prefix}_{label}"
    missing = [k for k in cap.KERNELS if k not in cap.inputs]
    if missing:
        raise SystemExit(f"{prefix} ({label}): the prefill ran no {missing}")
    logits, K = cap.inputs["fused_topk_route"]
    R, T, E = logits.shape
    row = _route_check(logits, K, tie_rows=0)
    _log_row("fused_topk_route", case, f"R{R}xT{T}xE{E}xK{K}", row)
    ids, C = cap.inputs["histogram_offsets"]
    hrow = _hist_check(ids, C)
    _log_row("histogram_offsets", case,
             f"R{ids.shape[0]}xN{ids.shape[1]}xC{C}", hrow)
    for name, r in (("fused_topk_route", row), ("histogram_offsets", hrow)):
        if not r["ok"]:
            raise SystemExit(f"{name} disagrees with its plain version at "
                             f"{case}")
        if name in KERNEL_ROWS:
            k = KERNEL_ROWS[name]
            k["max_abs_err"] = max(k["max_abs_err"], r["max_abs_err"])
    x, counts, slot_rows, experts, act = cap.inputs["moe_gemm"]
    if max_slots:
        x, counts, slot_rows = (t[:max_slots].contiguous()
                                for t in (x, counts, slot_rows))
    round_case(case, (x, counts, slot_rows, experts, act))
    cap.inputs.clear()


def t2e_controller_run(model, cfg, seed: int, predictor) -> None:
    """An ``OnlineGPSController`` that may choose Token-to-Expert, on the
    JAX default preset (A100-PCIe), drives the EP engine (store defaults,
    the conditional predictor attached) over the skew-shifting trace;
    checks completions, launches (two rounds per layer of each prefill
    under token_to_expert), the engine following every decision, every
    audit record replayed, and a switch into token_to_expert and one out
    of it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   ControllerConfig, OnlineGPSController)
    from repro_torch.workloads import skew_shift_trace, to_serve_requests

    full = get_config("mixtral-8x7b")
    ccfg = ControllerConfig(
        window_iters=8, patience=1,
        migration_bytes_scale=full.num_layers / cfg.num_layers)
    ctl = OnlineGPSController(full, ccfg, predictor_available=True)
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**GPS_CCFG),
                           ep_ranks=EP_RANKS, ep=True, predictor=predictor,
                           controller=ctl)
    t2e_prefills, follow_errors = [0], []
    predict = eng._predict_tokens

    def counted_predict(tokens):
        out = predict(tokens)
        t2e_prefills[0] += out is not None
        return out
    eng._predict_tokens = counted_predict
    apply_decision = eng._apply_decision

    def checked_apply(d):
        apply_decision(d)
        if (eng.strategy, eng.predict_interval) != (d.strategy,
                                                    d.predict_interval):
            follow_errors.append(f"t={d.t:.2f}: engine {eng.strategy}, "
                                 f"decision {d.strategy}")
    eng._apply_decision = checked_apply
    eng.warmup()
    reqs = to_serve_requests(skew_shift_trace(cfg.vocab_size, seed=seed,
                                              **T2E_CTL_TRACE))
    ops.reset_launches()
    t0 = time.perf_counter()
    eng.run_trace(reqs, time_scale=GPS_TIME_SCALE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    s = eng.metrics.summary()
    done = eng.scheduler.completed
    prefills = len(reqs) + int(s["preemptions"])
    decisions = ctl.decisions
    switches = [d for d in decisions if d.switched]
    log("t2e_gps", hardware=f"'{ccfg.hardware.name}'",
        min_saving=ccfg.min_saving, window_iters=ccfg.window_iters,
        requests=len(reqs), completed=len(done), iterations=eng.iterations,
        prefills=prefills, t2e_prefills=t2e_prefills[0],
        decode_steps=eng.decode_steps, wall_s=f"{wall:.3f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        decisions=len(decisions), switches=len(switches),
        switch_log=f"'{' | '.join(ctl.switch_log())}'")
    log("t2e_gps", window_skews=",".join(f"{d.skew:.4f}" for d in decisions),
        verdicts=",".join(str(d.recommended) for d in decisions),
        strategies=",".join(d.strategy for d in decisions),
        t2e_saving=",".join(f"{r.t2e_saving:.4f}"
                            for r in ctl.audit.records),
        dist_only_saving=",".join(f"{r.dist_only_saving:.4f}"
                                  for r in ctl.audit.records))
    log("t2e_gps", step_p50_ms=f"{s['step_p50_s'] * 1e3:.3f}",
        decode_toks_per_s=f"{s.get('decode_toks_per_s', 0.0):.2f}",
        dropped_pairs=int(s["dropped_tokens"]),
        measured_imbalance=f"{eng.measured_imbalance():.4f}",
        commits=int(s["migration_commits"]),
        predicted_counts=("none" if eng._pred_counts is None else
                          f"{eng._pred_counts.sum():.1f}"))
    failures = follow_errors[:3]
    if len(done) != len(reqs):
        failures.append(f"{len(done)} of {len(reqs)} requests completed")
    want = expected_launches(launches, cfg, prefills, eng.decode_steps,
                             ep=True, t2e_prefills=t2e_prefills[0])
    if launches != want:
        failures.append(f"kernel launches {launches} != {want}")
    replay_bad = audit_mismatches(ctl)
    log("t2e_gps", audit_records=len(ctl.audit),
        replayed_equal=not replay_bad)
    if replay_bad:
        failures.append(f"audit records {replay_bad[:4]} replay to another "
                        "verdict")
    into = [i for i, d in enumerate(decisions)
            if d.switched and d.strategy == "token_to_expert"]
    if not into:
        failures.append("no switch into token_to_expert")
    elif not any(d.switched for d in decisions[into[0] + 1:]):
        failures.append("no switch out of token_to_expert")
    if t2e_prefills[0] == 0 or eng._pred_counts is None:
        failures.append("no prefill ran on Token-to-Expert predictions")
    if failures:
        raise SystemExit("t2e controller run failed: " + "; ".join(failures))
    del eng
    free_engines()


def _proc_gb(path: str, key: str) -> float:
    """The ``key:`` line of a /proc file (in kB) in GB; NaN if unreadable."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return float("nan")


def free_engines(phase: str = "t2e") -> None:
    """Free the device memory of engines no longer referenced: the phases'
    instrumentation closures tie each engine into a reference cycle, which
    only the cycle collector breaks (an EP engine's store holds 22.5 GB).
    Logs what stays allocated on the card, and the host's resident and
    available memory."""
    gc.collect()
    torch.cuda.empty_cache()
    log(phase, allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}",
        host_rss_gb=f"{_proc_gb('/proc/self/status', 'VmRSS'):.3f}",
        host_available_gb=f"{_proc_gb('/proc/meminfo', 'MemAvailable'):.3f}")


def t2e_phase(model, cfg, seed: int) -> None:
    """Token-to-Expert prediction on the main path's Mixtral weights: fit
    the ladder, serve the main trace under ``token_to_expert`` with the
    conditional model and with the LSTM (each prefill layer a predicted
    and a correction round), hold a real correction round's ``moe_gemm``
    against its plain version, and replay the skew-shifting trace under a
    controller that may choose Token-to-Expert."""
    t0 = time.perf_counter()
    free_engines()
    rungs = fit_ladder(cfg, seed)
    for label, rung in (("t2e_conditional", "conditional"),
                        ("t2e_lstm", "lstm")):
        with _RoundCapture("predicted_idx") as rc:
            eng, _ = serve_trace(label, model, cfg, seed, ep=True,
                                 phase="t2e", predictor=rungs[rung],
                                 on_start=lambda eng: rc.reset())
            nums = rc.numbers()
        acc = eng.accuracy.summary()
        log("t2e", path=label, **nums, accuracy_windows=int(
            acc["pred_windows"]), window_hit_rate=(
            f"{acc['pred_hit_rate']:.4f}" if "pred_hit_rate" in acc
            else "none closed"))
        if nums["sent_to_correction"] == 0 or not rc.rings["prefill"]:
            raise SystemExit(f"t2e ({label}): no correction round ran")
        if rung == "conditional":
            round_case("prefill_correction", rc.latest("prefill"))
        del eng, rc
        free_engines()
    keys = ("step_p50_ms", "ttft_p50_ms", "decode_toks_per_s",
            "dropped_pairs", "measured_imbalance", "modelled_imbalance")
    for label in ("ep", "t2e_conditional", "t2e_lstm"):
        nums = MEASURED.get(f"serve/{label}")
        strategy = "dist_only" if label == "ep" else "token_to_expert"
        log("t2e_compare", path=label, strategy=strategy, **(
            {k: (f"{nums[k]:.4f}" if isinstance(nums[k], float) else nums[k])
             for k in keys} if nums else {"numbers": "not measured (phase "
                                                     "main not run)"}))
    t2e_controller_run(model, cfg, seed, rungs["conditional"])
    log("t2e", phase_s=f"{time.perf_counter() - t0:.3f}")


# ---------------------------------------------------------------------------
# phase resched: token rescheduling on the main path
# ---------------------------------------------------------------------------

# the JAX package's lever A/B (benchmarks/bench_serve_traces.py): constant
# prompts at capacity factor 0.5 overflow their slots
RESCHED_AB_CCFG = dict(max_slots=4, prefill_len=64, block_size=8, max_len=96,
                       strategy="dist_only", predict_interval=4,
                       metrics_window=4, dup_slots=DUP_SLOTS)
RESCHED_AB_LEGS = (("duplicate", "greedy"), ("reschedule", "greedy"),
                   ("both", "lp"))
RESCHED_CTL_TRACE = dict(horizon=45.0, rate=1.5)
RESCHED_REPLAN_RUNS = 20


def resched_ab(model, cfg, seed: int) -> None:
    """The JAX package's lever A/B at full width: 10 prompts of 40-60
    copies of token 7 at capacity factor 0.5, legs duplicate,
    reschedule (greedy) and both (LP); checks completions, launches and
    that the rescheduling legs engaged the lever."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   ServeRequest)

    ab_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    failures = []
    for lever, impl in RESCHED_AB_LEGS:
        eng = ContinuousEngine(ab_cfg, model, ContinuousConfig(
            **RESCHED_AB_CCFG, lever=lever, resched_impl=impl),
            ep_ranks=EP_RANKS, ep=True)
        quota_forwards = count_quota_forwards(eng)
        eng.warmup()
        rng = np.random.default_rng(0)
        reqs = []
        for i in range(10):
            tokens = np.full(int(rng.integers(40, 60)), 7, np.int32)
            reqs.append(ServeRequest(rid=i, arrival=i * 0.01, tokens=tokens,
                                     max_new_tokens=int(rng.integers(1, 6))))
        quota_forwards.update(prefill=0, decode=0)
        ops.reset_launches()
        eng.run_trace(reqs)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        s = eng.metrics.summary()
        prefills = len(reqs) + int(s["preemptions"])
        log("resched_ab", lever=lever, resched_impl=impl,
            capacity_factor=0.5, completed=len(eng.scheduler.completed),
            iterations=eng.iterations, prefills=prefills,
            decode_steps=eng.decode_steps,
            dropped_pairs=int(s["dropped_tokens"]),
            overflow_pairs=int(s["overflow_tokens"]),
            overflow_absorbed_frac=f"{s['overflow_absorbed_frac']:.4f}",
            resched_a2a_bytes=int(s["resched_a2a_bytes"]),
            resched_plans=int(s["resched_plans"]),
            resched_residual=f"{s['resched_residual']:.4f}",
            resched_absorbed_pred=f"{s['resched_absorbed_pred']:.4f}",
            zero_drops=s["dropped_tokens"] == 0,
            migration_replans=int(s["migration_replans"]),
            commits=int(s["migration_commits"]),
            step_p50_ms=f"{s['step_p50_s'] * 1e3:.3f}",
            launches=",".join(f"{k}:{v}" for k, v in launches.items()))
        if len(eng.scheduler.completed) != len(reqs):
            failures.append(f"{lever}: {len(eng.scheduler.completed)} of "
                            f"{len(reqs)} requests completed")
        want = expected_launches(launches, cfg, prefills, eng.decode_steps,
                                 ep=True,
                                 resched_prefills=quota_forwards["prefill"],
                                 resched_decodes=quota_forwards["decode"])
        if launches != want:
            failures.append(f"{lever}: kernel launches {launches} != {want}")
        if lever != "duplicate" and not (
                s["resched_plans"] >= 1 and s["overflow_tokens"] > 0
                and s["resched_a2a_bytes"] > 0):
            failures.append(f"{lever}: the lever did not engage (plans "
                            f"{s['resched_plans']}, overflow "
                            f"{s['overflow_tokens']}, a2a bytes "
                            f"{s['resched_a2a_bytes']})")
        if not 0.0 <= s["overflow_absorbed_frac"] <= 1.0:
            failures.append(f"{lever}: absorbed fraction "
                            f"{s['overflow_absorbed_frac']} outside [0, 1]")
        del eng
        free_engines("resched_ab")
    if failures:
        raise SystemExit("resched A/B failed: " + "; ".join(failures))


def replan_cost(eng) -> None:
    """Host milliseconds per quota re-plan, greedy against LP: the engine's
    ``_replan_resched`` at its 8 layers (the scheduler, the quota's copy to
    the card and the bookkeeping), and the scheduler alone on the same
    counts and plans at 8 and at 32 layers (tiled)."""
    from repro_torch.core.placement import PlacementPlan
    from repro_torch.moe.dispatch import capacity
    from repro_torch.schedule import make_scheduler

    m = eng.moe_cfg
    L = eng.cfg.num_layers
    counts = (eng.estimator.predict()
              * float(eng.ccfg.prefill_len * m.top_k))
    cap = float(capacity(eng.ccfg.prefill_len // EP_RANKS, m.top_k,
                         (m.num_experts // EP_RANKS + m.duplication_slots)
                         * EP_RANKS, m.capacity_factor) * EP_RANKS)
    plan = eng._plan_stack
    plans = [PlacementPlan(*(np.asarray(a)[l] for a in plan))
             for l in range(L)]
    out = {}
    for impl in ("greedy", "lp"):
        sched = make_scheduler(impl)
        eng._resched_sched = sched
        ms = []
        for _ in range(RESCHED_REPLAN_RUNS):
            t0 = time.perf_counter()
            eng._replan_resched()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"{impl}_engine_8_layers_ms"] = f"{np.median(ms):.4f}"
        for layers in (L, 32):
            reps = -(-layers // L)
            c = np.tile(counts, (reps, 1))[:layers]
            p = (plans * reps)[:layers]
            ms = []
            for _ in range(RESCHED_REPLAN_RUNS):
                t0 = time.perf_counter()
                sched.plan_stack(c, p, ep_ranks=EP_RANKS,
                                 dup_slots=m.duplication_slots, cap=cap)
                ms.append((time.perf_counter() - t0) * 1e3)
            out[f"{impl}_scheduler_{layers}_layers_ms"] = \
                f"{np.median(ms):.4f}"
    log("resched_replan", runs=RESCHED_REPLAN_RUNS, cap_pairs=cap,
        plan_replicas=int((np.asarray(plan.n_replicas) - 1).sum()), **out)


def resched_controller_run(model, cfg, seed: int) -> None:
    """An ``OnlineGPSController`` offered all three levers (the gps phase's
    H100 preset and ``min_saving``) drives the EP engine over
    ``skew_shift_trace(horizon=45)``; checks completions, launches (a
    rescue round per layer of every forward given a quota), the engine
    following every decision's strategy, lever and interval, and every
    audit record replayed. How often the lever switches is the traffic's
    verdict, not a check."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.simulator import H100_SXM_NVLINK
    from repro_torch.kernels import ops
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   ControllerConfig, OnlineGPSController)
    from repro_torch.workloads import skew_shift_trace, to_serve_requests

    full = get_config("mixtral-8x7b")
    ccfg = ControllerConfig(
        hardware=H100_SXM_NVLINK, window_iters=8, patience=1,
        min_saving=GPS_MIN_SAVING,
        migration_bytes_scale=full.num_layers / cfg.num_layers,
        levers=("duplicate", "reschedule", "both"))
    ctl = OnlineGPSController(full, ccfg, predictor_available=False)
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**GPS_CCFG),
                           ep_ranks=EP_RANKS, ep=True, controller=ctl)
    quota_forwards = count_quota_forwards(eng)
    follow_errors = []
    apply_decision = eng._apply_decision

    def checked_apply(d):
        apply_decision(d)
        got = (eng.strategy, eng.predict_interval)
        if got != (d.strategy, d.predict_interval) or (
                d.strategy != "none" and eng.lever != d.lever):
            follow_errors.append(f"t={d.t:.2f}: engine {got} {eng.lever}, "
                                 f"decision {d.strategy} {d.lever}")
    eng._apply_decision = checked_apply
    eng.warmup()
    reqs = to_serve_requests(skew_shift_trace(cfg.vocab_size, seed=seed,
                                              **RESCHED_CTL_TRACE))
    quota_forwards.update(prefill=0, decode=0)
    ops.reset_launches()
    t0 = time.perf_counter()
    eng.run_trace(reqs, time_scale=GPS_TIME_SCALE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    s = eng.metrics.summary()
    done = eng.scheduler.completed
    prefills = len(reqs) + int(s["preemptions"])
    decisions = ctl.decisions
    recs = ctl.audit.records
    switches = [d for d in decisions if d.switched]
    log("resched_gps", hardware=f"'{ccfg.hardware.name}'",
        min_saving=ccfg.min_saving, levers=",".join(ccfg.levers),
        requests=len(reqs), completed=len(done), iterations=eng.iterations,
        prefills=prefills, decode_steps=eng.decode_steps,
        quota_prefills=quota_forwards["prefill"],
        quota_decodes=quota_forwards["decode"], wall_s=f"{wall:.3f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        decisions=len(decisions), switches=len(switches),
        switch_log=f"'{' | '.join(ctl.switch_log())}'")
    log("resched_gps",
        window_skews=",".join(f"{d.skew:.4f}" for d in decisions),
        verdicts=",".join(f"{d.recommended}+{d.lever_recommended}"
                          for d in decisions),
        in_force=",".join(f"{d.strategy}+{d.lever}" for d in decisions),
        lever_switches=sum(1 for a, b in zip(decisions, decisions[1:])
                           if "none" not in (a.lever, b.lever)
                           and a.lever != b.lever),
        resched_saving=",".join(f"{r.resched_saving:.4f}" for r in recs),
        dist_only_saving=",".join(f"{r.dist_only_saving:.4f}" for r in recs))
    log("resched_gps",
        resched_residual_fed=",".join(f"{r.resched_residual:.4f}"
                                      for r in recs),
        resched_absorbed_pred_fed=",".join(f"{r.overflow_pred_frac:.4f}"
                                           for r in recs),
        resched_extra_frac_fed=",".join(f"{r.resched_extra_frac:.4f}"
                                        for r in recs),
        overflow_realized_frac=",".join(f"{r.overflow_realized_frac:.4f}"
                                        for r in recs))
    log("resched_gps", step_p50_ms=f"{s['step_p50_s'] * 1e3:.3f}",
        decode_toks_per_s=f"{s.get('decode_toks_per_s', 0.0):.2f}",
        dropped_pairs=int(s["dropped_tokens"]),
        overflow_pairs=int(s["overflow_tokens"]),
        overflow_absorbed_frac=f"{s['overflow_absorbed_frac']:.4f}",
        resched_plans=int(s["resched_plans"]),
        measured_imbalance=f"{eng.measured_imbalance():.4f}",
        commits=int(s["migration_commits"]))
    failures = follow_errors[:3]
    if len(done) != len(reqs):
        failures.append(f"{len(done)} of {len(reqs)} requests completed")
    want = expected_launches(launches, cfg, prefills, eng.decode_steps,
                             ep=True,
                             resched_prefills=quota_forwards["prefill"],
                             resched_decodes=quota_forwards["decode"])
    if launches != want:
        failures.append(f"kernel launches {launches} != {want}")
    replay_bad = audit_mismatches(ctl)
    log("resched_gps", audit_records=len(recs), replayed_equal=not replay_bad)
    if replay_bad:
        failures.append(f"audit records {replay_bad[:4]} replay to another "
                        "verdict")
    if not decisions:
        failures.append("no decision")
    if failures:
        raise SystemExit("resched controller run failed: "
                         + "; ".join(failures))
    del eng
    free_engines("resched_gps")


def resched_phase(model, cfg, seed: int) -> None:
    """Token rescheduling on the main path's Mixtral weights: the JAX
    package's lever A/B at full width; the main trace under "reschedule"
    and "both" beside phase 4's dist_only run, with the rescue rounds'
    ``moe_gemm`` inputs held against the plain version; the host cost of
    a quota re-plan; a controller that may choose the lever."""
    import contextlib

    t0 = time.perf_counter()
    free_engines("resched")
    resched_ab(model, cfg, seed)
    for lever in ("reschedule", "both"):
        label = f"resched_{lever}"
        # the rescue rounds' inputs are kept in the "reschedule" run only
        # (three device copies per round there; "both" runs uninstrumented)
        cap = _RoundCapture("resched_quota") if lever == "reschedule" \
            else None
        with cap or contextlib.nullcontext():
            eng, _ = serve_trace(label, model, cfg, seed, ep=True,
                                 phase="resched", lever=lever)
        s = eng.metrics.summary()
        log("resched", path=label, resched_impl=eng.ccfg.resched_impl,
            overflow_pairs=int(s["overflow_tokens"]),
            dropped_pairs=int(s["dropped_tokens"]),
            overflow_absorbed_frac=f"{s['overflow_absorbed_frac']:.4f}",
            resched_a2a_bytes=int(s["resched_a2a_bytes"]),
            resched_plans=int(s["resched_plans"]),
            resched_residual=f"{s['resched_residual']:.4f}",
            resched_absorbed_pred=f"{s['resched_absorbed_pred']:.4f}")
        if cap is not None:
            log("resched", path=label, rescue_rounds_run=",".join(
                f"{k}:{v}" for k, v in cap.seen.items()))
            for kind in ("prefill", "decode"):
                if not cap.rings[kind]:
                    raise SystemExit(f"resched: no {kind} rescue round ran")
                # (the kept inputs hold views of the store's rows: nothing
                # may keep them past this loop). At 8 slots a decode step
                # cannot overflow (a slot gets at most 8 pairs, its
                # capacity is 8), so decode_rescue has no live row: it
                # holds the launch and its cost, not the arithmetic, which
                # phase 3's decode cases check at this shape
                # (arithmetic_checked in its log line)
                round_case(f"{kind}_rescue", cap.busiest(kind))
            cap.rings.clear()
            # decode steps with a rescue round per layer, beside phase 4's
            # profile of the same engine kind without one
            profile_phase(eng, cfg, seed, label)
        else:
            replan_cost(eng)
        del eng, cap
        free_engines("resched")
    keys = ("step_p50_ms", "ttft_p50_ms", "decode_toks_per_s",
            "dropped_pairs", "overflow_pairs", "overflow_absorbed_frac",
            "measured_imbalance", "modelled_imbalance", "peak_gb")
    for label in ("ep", "resched_reschedule", "resched_both"):
        nums = MEASURED.get(f"serve/{label}")
        lever = "duplicate" if label == "ep" else label.split("_")[1]
        log("resched_compare", path=label, lever=lever, **(
            {k: (f"{nums[k]:.4f}" if isinstance(nums[k], float) else nums[k])
             for k in keys} if nums else {"numbers": "not measured (phase "
                                                     "main not run)"}))
    resched_controller_run(model, cfg, seed)
    log("resched", phase_s=f"{time.perf_counter() - t0:.3f}")


# ---------------------------------------------------------------------------
# phase serve_ep: ServeEngine's expert-parallel half on the main path
# ---------------------------------------------------------------------------

SERVE_EP_BATCHES, SERVE_EP_B, SERVE_EP_S, SERVE_EP_NEW = 3, 8, 512, 24
SERVE_EP_KW = dict(strategy="dist_only", predict_interval=1,
                   dup_slots=DUP_SLOTS, max_len=SERVE_EP_S + SERVE_EP_NEW)
# capacity() then covers every (token, k) pair a rank can send to a slot
NODROP_CF = float(EP_RANKS * (8 // EP_RANKS + DUP_SLOTS))       # 12.0
# leg -> (ServeConfig changes, MoEConfig changes)
SERVE_EP_LEGS = {
    "store": ({}, {}),
    "sync": ({}, dict(overlap_migration=False)),
    "gather": ({}, dict(replica_impl="gather")),
    "store_nodrop": ({}, dict(capacity_factor=NODROP_CF)),
    "sync_nodrop": ({}, dict(capacity_factor=NODROP_CF,
                             overlap_migration=False)),
    "in_graph": (dict(in_graph_replan=True), {}),
    "reschedule": (dict(lever="reschedule", resched_impl="greedy"), {}),
    "both": (dict(lever="both", resched_impl="lp"), {}),
}
PLAN_TIMING_RUNS = 20
# legs whose last prefill's kernel inputs are kept (``_PrefillCapture``)
# and held against the plain versions: capacity factor 1.25 and 12
CAPTURE_LEGS = ("store", "store_nodrop")


def serve_ep_leg(label: str, model, cfg, batches, serve_kw, moe_kw,
                 cap=None):
    """One leg: ``ServeEngine(ep=True)`` generates ``SERVE_EP_NEW`` tokens
    for each batch, every kernel count set to 0 just before and read just
    after. Each prefill and decode step is timed on the host clock between
    two synchronisations. With ``cap`` (a ``_PrefillCapture`` installed by
    the caller) the last batch's prefill is captured (its copies are in
    that prefill's time). Returns the leg's record."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServeEngine

    free_engines("serve_ep")
    leg_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    eng = ServeEngine(leg_cfg, model, ServeConfig(**SERVE_EP_KW, **serve_kw),
                      ep_ranks=EP_RANKS, ep=True)
    rec = {"prefill_ms": [], "decode_ms": [], "quota": {"prefill": 0,
                                                        "decode": 0},
           "counts": [], "plans": [], "imbalance": []}
    dec_dropped = torch.zeros((), dtype=torch.float64, device=model.device)
    step_prefill, step_decode = eng._prefill, eng._decode

    def prefill_step(*a, **kw):
        rec["quota"]["prefill"] += kw.get("resched") is not None
        if cap is not None:
            cap.armed = len(rec["prefill_ms"]) == len(batches) - 1
        out = step_prefill(*a, **kw)
        if cap is not None:
            cap.armed = False
        if eng._in_graph:
            rec["counts"].append(out[2]["expert_counts"].clone())
        return out

    def decode_step(*a, **kw):
        nonlocal dec_dropped
        rec["quota"]["decode"] += kw.get("resched") is not None
        out = step_decode(*a, **kw)
        dec_dropped = dec_dropped + out[3]["dropped"].sum()
        return out
    eng._prefill, eng._decode = prefill_step, decode_step
    prefill, decode = eng.prefill, eng.decode

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t0) * 1e3)
            if key == "prefill_ms":
                rl = eng.rank_loads(out[2]["slot_counts"].cpu().numpy())
                rec["imbalance"].append(float(np.mean(
                    rl.max(1) / np.maximum(rl.mean(1), 1e-9))))
            return out
        return run
    eng.prefill, eng.decode = timed(prefill, "prefill_ms"), \
        timed(decode, "decode_ms")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tokens, history, migration = [], [], []
    for b in batches:
        out, _ = eng.generate({"tokens": b}, max_new_tokens=SERVE_EP_NEW)
        tokens.append(out.cpu().numpy())
        history.append(dict(eng.history[-1]))
        migration.append(dict(eng._last_migration))
        if eng._in_graph:
            rec["plans"].append([t.cpu().numpy() for t in eng._plan_stack])
    torch.cuda.synchronize()
    rec.update(launches=dict(ops.LAUNCHES), tokens=tokens, history=history,
               migration=migration, decode_dropped=float(dec_dropped),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, engine=eng)
    return rec


def _in_graph_checks(rec, cfg) -> list:
    """The in-graph leg's plans against ``duplicate_experts_device`` run
    on the CPU on the same counts; the planning call's CUDA-event time
    and its run under ``torch.cuda.set_sync_debug_mode("error")``, beside
    the host planner over the same layers."""
    from repro_torch.core.duplication import (duplicate_experts_device,
                                              duplicate_experts_host)

    m = rec["engine"].moe_cfg
    failures, dev_ms, host_ms = [], [], []
    for k, (counts, plan) in enumerate(zip(rec["counts"], rec["plans"])):
        want = duplicate_experts_device(counts.cpu(), EP_RANKS,
                                        m.duplication_slots, m.max_copies)
        same = all(np.array_equal(a, b.numpy()) for a, b in zip(plan, want))
        if not same:
            failures.append(f"in_graph batch {k}: the device plan differs "
                            "from the CPU planner's")
        times = []
        for _ in range(PLAN_TIMING_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            duplicate_experts_device(counts, EP_RANKS, m.duplication_slots,
                                     m.max_copies)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        dev_ms.append(float(np.median(times)))
        dist = counts.cpu().double().numpy()
        dist = dist / np.maximum(dist.sum(1, keepdims=True), 1e-9)
        times = []
        for _ in range(PLAN_TIMING_RUNS):
            t0 = time.perf_counter()
            for l in range(cfg.num_layers):
                duplicate_experts_host(dist[l], EP_RANKS,
                                       m.duplication_slots, m.max_copies)
            times.append((time.perf_counter() - t0) * 1e3)
        host_ms.append(float(np.median(times)))
        log("serve_ep", path="in_graph", batch=k, plan_equals_cpu=same,
            replicas=int((plan[0] - 1).sum()),
            plan_device_ms=f"{dev_ms[-1]:.4f}",
            plan_host_ms_8_layers=f"{host_ms[-1]:.4f}")
    counts = rec["counts"][-1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        duplicate_experts_device(counts, EP_RANKS, m.duplication_slots,
                                 m.max_copies)
        clean = True
    except RuntimeError as e:
        clean = False
        failures.append(f"in_graph: the planning call synchronised ({e})")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("serve_ep", path="in_graph", sync_debug_error_mode_clean=clean,
        plan_device_ms_median=f"{np.median(dev_ms):.4f}",
        plan_host_ms_8_layers_median=f"{np.median(host_ms):.4f}")
    return failures


def serve_ep_phase(model, cfg, seed: int) -> None:
    """``ServeEngine(ep=True)`` on the main path's Mixtral weights: every
    leg of ``SERVE_EP_LEGS`` serves the same 3 batches of 8 x 512 Zipf
    prompts (24 new tokens each, a re-plan per batch); checks tokens,
    launches, the store against gather, overlap against synchronous fills
    where nothing drops, the in-graph plans, and the lever's quotas."""
    import contextlib

    from repro_torch.data.synthetic import token_batches

    t0 = time.perf_counter()
    log("serve_ep", model=cfg.name, layers=cfg.num_layers,
        reduced=f"num_layers 32->{cfg.num_layers} (32 bf16 layers ~93 GB "
                "> 80 GB)", batches=SERVE_EP_BATCHES,
        batch=SERVE_EP_B, seq=SERVE_EP_S, new_tokens=SERVE_EP_NEW,
        ep_ranks=EP_RANKS, dup_slots=DUP_SLOTS, nodrop_cf=NODROP_CF)
    gen = token_batches(seed, cfg.vocab_size, SERVE_EP_B, SERVE_EP_S)
    batches = [next(gen)["tokens"] for _ in range(SERVE_EP_BATCHES)]
    decode_steps = SERVE_EP_BATCHES * (SERVE_EP_NEW - 1)
    recs, failures = {}, []
    for label, (serve_kw, moe_kw) in SERVE_EP_LEGS.items():
        cap = _PrefillCapture() if label in CAPTURE_LEGS else None
        with cap or contextlib.nullcontext():
            rec = recs[label] = serve_ep_leg(label, model, cfg, batches,
                                             serve_kw, moe_kw, cap)
        eng = rec["engine"]
        q = rec["quota"]
        want = expected_launches(rec["launches"], cfg, SERVE_EP_BATCHES,
                                 decode_steps, ep=True,
                                 resched_prefills=q["prefill"],
                                 resched_decodes=q["decode"], paged=False)
        if rec["launches"] != want:
            failures.append(f"{label}: kernel launches {rec['launches']} "
                            f"!= {want}")
        for k, toks in enumerate(rec["tokens"]):
            if toks.shape != (SERVE_EP_B, SERVE_EP_NEW) or (toks < 0).any() \
                    or (toks >= cfg.vocab_size).any():
                failures.append(f"{label} batch {k}: bad tokens")
        if serve_kw.get("lever", "duplicate") != "duplicate" and (
                q["prefill"] != SERVE_EP_BATCHES - 1
                or q["decode"] != decode_steps):
            # the first prefill runs before the first re-plan made quotas
            failures.append(f"{label}: forwards with a quota {q} != "
                            f"{SERVE_EP_BATCHES - 1} prefills, "
                            f"{decode_steps} decode steps")
        dec = sorted(rec["decode_ms"])
        hist = rec["history"]
        log("serve_ep", path=label, store=eng._store is not None,
            overlap=eng._overlap, in_graph=eng._in_graph,
            lever=eng.serve.lever, resched_impl=eng.serve.resched_impl,
            capacity_factor=eng.moe_cfg.capacity_factor,
            prefill_ms=",".join(f"{t:.3f}" for t in rec["prefill_ms"]),
            decode_step_p50_ms=f"{dec[len(dec) // 2]:.3f}",
            decode_toks_per_s=f"{SERVE_EP_B * len(dec) / (sum(dec) / 1e3):.2f}",
            prefill_dropped=",".join(str(int(h["dropped"])) for h in hist),
            prefill_overflow=",".join(str(int(h["overflow"])) for h in hist),
            decode_dropped=int(rec["decode_dropped"]),
            window_skew=",".join(f"{h['skew']:.4f}" for h in hist),
            rank_imbalance=",".join(f"{x:.4f}" for x in rec["imbalance"]),
            migration_entries=",".join(str(h.get("migration_entries", "-"))
                                       for h in hist),
            migration_bytes=",".join(str(h.get("migration_bytes", "-"))
                                     for h in hist),
            steps_to_adopt=",".join(str(m.get("steps_to_adopt", "-"))
                                    for m in rec["migration"]),
            resched_residual=",".join(
                f"{h['resched_residual']:.4f}" if "resched_residual" in h
                else "-" for h in hist),
            quota_forwards=f"{q['prefill']}+{q['decode']}",
            launches=",".join(f"{k}:{v}"
                              for k, v in rec["launches"].items()),
            peak_gb=f"{rec['peak_gb']:.3f}")
        if label == "in_graph":
            failures += _in_graph_checks(rec, cfg)
        if cap is not None:
            # (the kept moe_gemm inputs name the engine's weight rows)
            prefill_cases(label, cap)
        del rec["engine"], eng, cap
    free_engines("serve_ep")

    def same_ids(a, b):
        return all(np.array_equal(x, y) for x, y in zip(
            recs[a]["tokens"], recs[b]["tokens"]))
    checks = {"sync_equals_gather": same_ids("sync", "gather"),
              "store_nodrop_equals_sync_nodrop": same_ids("store_nodrop",
                                                          "sync_nodrop")}
    for label in ("store_nodrop", "sync_nodrop"):
        dropped = sum(h["dropped"] for h in recs[label]["history"]) \
            + recs[label]["decode_dropped"]
        checks[f"{label}_dropped_0"] = dropped == 0
    log("serve_ep", **checks, phase_s=f"{time.perf_counter() - t0:.3f}")
    failures += [k for k, ok in checks.items() if not ok]
    if failures:
        raise SystemExit("serve_ep failed: " + "; ".join(failures))


def _events_by_stream(prof, start_us: float = float("-inf")):
    """{device resource (stream) id: [(name, device ms)]} of a profile's
    device events that start at ``start_us`` or later (the tracer's copy of
    the ``FILL_RANGE`` annotation on each stream left out)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.start >= start_us \
                and e.name != FILL_RANGE:
            out.setdefault(getattr(e, "device_resource_id", -1), []).append(
                (e.name, e.time_range.elapsed_us() / 1e3))
    return out


def _measured(x):
    """``x`` with every NaN (a profiler time no session kept) as None, so
    that the line stays JSON."""
    if isinstance(x, dict):
        return {k: _measured(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_measured(v) for v in x]
    return None if isinstance(x, float) and x != x else x


def _kernel_time_by_name(prof, iters: int):
    """{kernel name: [device ms per iteration, launches]} of a profile."""
    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3 / iters
            k[1] += 1
    return kernels


def griffin_phase(seed: int):
    """RecurrentGemma-2B at published widths and all 26 layers, random
    weights from ``seed``, through the command a user runs
    (``repro_torch.launch.serve.main``): 16 requests of 3072 Zipf tokens in
    batches of 8, 64 new tokens each, so max_len 3136 and the local
    layers' rotating buffer holds W = 2048 (the prompts are longer than the
    window and every decode step wraps it). Kernel counts are set to 0
    just before the run and read just after. Returns the launches."""
    import contextlib
    import io

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    cfg = get_config("recurrentgemma-2b")
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.num_layers)]
    n_rec = kinds.count("recurrent")
    log("griffin", model=cfg.name, layers=cfg.num_layers,
        recurrent_layers=n_rec, local_layers=cfg.num_layers - n_rec,
        d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, rnn_width=cfg.rnn_width,
        local_window=cfg.local_window, vocab=cfg.vocab_size,
        reduced="none (published widths, all 26 layers)")
    a = GRIFFIN_ARGS
    trace = os.path.join(ROOT, "build", "chip_smoke", "griffin_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    argv = ["--arch", cfg.name, "--requests", str(a["requests"]),
            "--batch", str(a["batch"]), "--seq", str(a["seq"]),
            "--new-tokens", str(a["new_tokens"]), "--seed", str(seed),
            "--device", "cuda", "--trace-out", trace]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launch_serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in out.getvalue().splitlines():
        log("griffin", stdout=f"'{line}'")
    with open(trace) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    prefill_ms = [e["dur"] / 1e3 for e in spans if e["name"] == "prefill"]
    decode_ms = [e["dur"] / 1e3 for e in spans if e["name"] == "decode"]
    batches = -(-a["requests"] // a["batch"])
    served = f"served {a['requests']} requests"
    log("griffin", argv=f"'{' '.join(argv)}'", rc=rc,
        completed=f"{a['requests'] if served in out.getvalue() else '?'}"
                  f" of {a['requests']}",
        prefills=len(prefill_ms), decode_steps=len(decode_ms),
        prefill_ms_per_batch_p50=f"{np.median(prefill_ms):.3f}",
        decode_ms_per_step_p50=f"{np.median(decode_ms):.3f}",
        decode_toks_per_s=f"{a['batch'] / np.median(decode_ms) * 1e3:.2f}",
        wall_s=f"{wall:.3f}", peak_gb=f"{peak_gb:.3f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    failures = []
    if rc != 0 or served not in out.getvalue():
        failures.append(f"launch.serve exit {rc}: not every request completed")
    if len(prefill_ms) != batches or \
            len(decode_ms) != batches * (a["new_tokens"] - 1):
        failures.append(f"{len(prefill_ms)} prefills, {len(decode_ms)} "
                        "decode steps in the trace")
    want = {k: 0 for k in launches}
    want["rg_lru_scan"] = n_rec * batches
    if launches != want:
        failures.append(f"kernel launches {launches} != {want}")
    if failures:
        raise SystemExit("Griffin main path failed: " + "; ".join(failures))
    torch.cuda.empty_cache()
    return launches


def griffin_profile_phase(seed: int, steps: int = 6) -> None:
    """The same full-width Griffin weights (the same seed) in a
    ``ServeEngine``: one batch of 8 x 3072 prompts prefilled (its logits
    finite, of shape (8, 1, V)), 2 decode steps on the host clock, then
    ``steps`` more under torch.profiler: device busy time by kernel and the
    idle share of the profiled window; the next tokens must lie in the
    vocabulary."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config("recurrentgemma-2b")
    a = GRIFFIN_ARGS
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    eng = ServeEngine(cfg, model, ServeConfig(
        max_len=a["seq"] + a["new_tokens"]))
    toks = next(token_batches(seed, cfg.vocab_size, a["batch"], a["seq"]))
    logits, cache, _ = eng.prefill({"tokens": toks["tokens"]})
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    ok = (tuple(logits.shape) == (a["batch"], 1, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()))
    pos = a["seq"]
    for _ in range(2):
        tok, _, cache, _ = eng.decode(tok, cache, pos)
        pos += 1
    torch.cuda.synchronize()

    def decode_steps():
        nonlocal tok, cache, pos
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, _, cache, _ = eng.decode(tok, cache, pos)
            pos += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    prof, wall_ms = profiled(decode_steps, "the Griffin decode step",
                             cpu=True)
    host = tok.cpu()
    ok = ok and bool(((host >= 0) & (host < cfg.vocab_size)).all())
    kernels = {} if prof is None else _kernel_time_by_name(prof, steps)
    busy = sum(ms for ms, _ in kernels.values()) if kernels else NOT_MEASURED
    log("griffin_profile", decode_steps=steps, batch=a["batch"],
        cache_len=pos, profiled_step_ms=f"{wall_ms:.3f}",
        device_busy_ms_per_step=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall_ms:.4f}",
        device_ops_per_step=f"{sum(n for _, n in kernels.values()) / steps:.1f}",
        logits_ok=ok)
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        log("griffin_profile", ms_per_step=f"{ms:.4f}",
            share=f"{ms / busy:.4f}", per_step=f"{n / steps:.1f}",
            kernel=f"'{name[:90]}'")
    if not ok:
        raise SystemExit("Griffin profile run: non-finite logits or tokens "
                         "outside the vocabulary")
    del eng, model, cache, logits
    torch.cuda.empty_cache()


def _reference_run(model, cfg, rt, plan, prompt, forced, S: int, bs: int):
    """A slot prefill of ``prompt`` (bucket S) and teacher-forced paged
    decode steps. Returns (logits (1 + steps, 1, V) fp32 on the host, the
    per-step stats moved to the host)."""
    from repro_torch.serve.kvcache import init_block_pool, write_prefill_blocks
    from repro_torch.train.steps import (make_paged_decode_step,
                                         make_slot_prefill_step)

    dev = model.device
    prefill = make_slot_prefill_step(cfg, rt)
    decode = make_paged_decode_step(cfg, rt)
    toks = np.zeros((1, S), np.int32)
    toks[0, :len(prompt)] = prompt
    tw = (np.arange(S) < len(prompt)).astype(np.float32)[None]
    _, lg, temp, st = prefill(model, torch.tensor(toks, device=dev), None,
                              torch.tensor([len(prompt) - 1], device=dev),
                              torch.tensor(tw, device=dev), plan)
    out, stats = [lg.float().cpu()], [st]
    pool = init_block_pool(cfg, 1 + 64 // bs, bs, device=dev)
    table = np.arange(1, 1 + 64 // bs, dtype=np.int32)
    write_prefill_blocks(pool, temp, table[:S // bs])
    for t in range(len(forced)):
        ln = torch.tensor([len(prompt) + t], dtype=torch.int32, device=dev)
        _, lg, pool, st = decode(
            model, torch.tensor([[forced[t]]], device=dev), pool,
            torch.tensor(table[None], device=dev), ln,
            torch.ones((1, 1), device=dev), plan)
        out.append(lg.float().cpu())
        stats.append(st)
    host = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in s.items()}
            for s in stats]
    return torch.cat(out), host


def _near_tie_routes(run):
    """Call ``run()`` with the model's router recorded. Returns its result
    and the number of routing decisions whose sorted top-(K+1)
    probabilities hold two within 2% of each other: decisions that bf16
    differences between two devices' hidden states may break differently."""
    import repro_torch.models.moe as mm
    import repro_torch.models.transformer as tr

    route, near = tr.route, [0]

    def recording(w, moe, x):
        out = route(w, moe, x)
        top = torch.sort(out.probs, dim=-1,
                         descending=True).values[..., :moe.top_k + 1]
        near[0] += int((top[..., :-1] - top[..., 1:]
                        < 0.02 * top[..., :-1]).any(-1).sum())
        return out
    # the EP path routes in the model, the dense path in models.moe
    tr.route = mm.route = recording
    try:
        return run(), near[0]
    finally:
        tr.route = mm.route = route


def reference_phase(seed: int):
    """Reduced Mixtral on the card (kernel path) against the same weights
    on the CPU (plain path): a prefill and three teacher-forced decode
    steps, on the dense path and on the EP path (4 ranks, one replica slot
    each, a duplicated plan). Logits are compared at a bf16 tolerance. On
    the EP path slot counts and dropped pairs must be equal; the router
    weights are scaled by 25 so that routing margins stand clear of the
    bf16 noise between the two devices, and where the CPU run still holds
    near-tie decisions each may move at most two pairs."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.core.duplication import duplicate_experts_host
    from repro_torch.core.placement import stack_plans
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Runtime, init_model

    base = get_config("mixtral-8x7b").reduced()
    gpu = init_model(base, torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda")
    with torch.no_grad():
        for layer in gpu.layers:
            layer.router.mul_(25.0)
    cpu = params_from_jax(params_to_jax(gpu), base, device="cpu")
    rng = np.random.default_rng(seed)
    S, bs, n_dec = 32, 8, 3
    prompt = rng.integers(0, base.vocab_size, 20).astype(np.int32)
    forced = rng.integers(0, base.vocab_size, n_dec).astype(np.int32)
    dist = np.array([[0.55, 0.15, 0.2, 0.1], [0.1, 0.2, 0.1, 0.6]])
    plan = stack_plans([duplicate_experts_host(dist[l], EP_RANKS, DUP_SLOTS,
                                               base.moe.max_copies).plan
                        for l in range(base.num_layers)])
    ep_cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, duplication_slots=DUP_SLOTS))
    paths = {
        "dense": (base, Runtime(window_override=64), None),
        "ep": (ep_cfg, Runtime(window_override=64, ep=True,
                               ep_ranks=EP_RANKS), plan)}
    failures = []
    for path, (cfg, rt, pl) in paths.items():
        logits, stats, launches = {}, {}, {}
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            ops.reset_launches()
            (logits[name], stats[name]), near = _near_tie_routes(
                lambda: _reference_run(model, cfg, rt, pl, prompt, forced, S,
                                       bs))
            launches[name] = dict(ops.LAUNCHES)
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        scale = float(logits["cpu"].abs().max())
        L = cfg.num_layers
        want = {k: 0 for k in launches["cuda"]}
        want.update(paged_decode_attention=n_dec * L,
                    fused_topk_route=(1 + n_dec) * L)
        for k in EP_KERNELS:
            want[k] = (1 + n_dec) * L if path == "ep" else 0
        ok = (bool(torch.isfinite(logits["cuda"]).all())
              and err <= 5e-2 * max(scale, 1.0)
              and launches["cuda"] == want
              and not any(launches["cpu"].values()))
        ep_stats = {}
        if path == "ep":
            moved = {k: sum(int((a[k].to(torch.int64)
                                 - b[k].to(torch.int64)).abs().sum())
                            for a, b in zip(stats["cuda"], stats["cpu"]))
                     for k in ("slot_counts", "dropped")}
            ok = ok and all(v <= 2 * near for v in moved.values())
            ep_stats = dict(
                slot_count_pairs_moved=moved["slot_counts"],
                dropped_moved=moved["dropped"],
                dropped_pairs=sum(int(s_["dropped"].sum())
                                  for s_ in stats["cpu"]))
        log("reference", path=path, model=cfg.name,
            steps=f"prefill+{n_dec}decode", max_abs_err=f"{err:.6g}",
            logit_scale=f"{scale:.6g}",
            tolerance="5e-2 x max|logit| (bf16 activations, CPU vs GPU sums)",
            near_tie_routes_cpu=near, **ep_stats,
            kernel_launches=",".join(f"{k}:{v}" for k, v in
                                     launches["cuda"].items()), ok=ok)
        if not ok:
            failures.append(path)
    if failures:
        raise SystemExit(f"reduced model on the card disagrees with the CPU "
                         f"path: {failures}")


def griffin_reference_phase(seed: int):
    """Reduced Griffin (3 layers: recurrent, recurrent, local; window 32)
    on the card (rg_lru_scan kernel) against the same weights on the CPU
    (plain version): a prefill of two 45-token prompts, longer than the
    window, then four teacher-forced decode steps that wrap the rotating
    buffer. Logits within 5e-2 (``LOGIT_ATOL`` of the CPU parity tests,
    where the CPU path is held against the JAX package); the recurrent
    states within 5e-3, the tolerance of ``tests/test_torch_griffin.py``'s
    block test: the scan itself is bit-exact (phase 3), but its inputs come
    from bf16 projections that cuBLAS and the CPU round apart by an ulp
    here and there, and the state follows ``i * x`` closely."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Runtime, init_cache, init_model
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_config("recurrentgemma-2b").reduced()
    gpu = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda")
    cpu = params_from_jax(params_to_jax(gpu), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    B, S, n_dec = 2, 45, 4
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, n_dec)).astype(np.int32)
    rt = Runtime()
    prefill, decode = make_prefill_step(cfg, rt), make_decode_step(cfg, rt)
    logits, states, launches = {}, {}, {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        dev = model.device
        ops.reset_launches()
        cache = init_cache(cfg, rt, B, S + n_dec, device=dev)
        lg, cache, _ = prefill(model, torch.tensor(prompt, device=dev), cache)
        out = [lg.float().cpu()]
        for t in range(n_dec):
            _, lg, cache, _ = decode(
                model, torch.tensor(forced[:, t:t + 1], device=dev), cache,
                S + t)
            out.append(lg.float().cpu())
        logits[name] = torch.cat(out, dim=1)
        states[name] = [c["h"].cpu() for c in cache if "h" in c]
        launches[name] = dict(ops.LAUNCHES)
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    h_err = max(float((a - b).abs().max())
                for a, b in zip(states["cuda"], states["cpu"]))
    n_rec = len(states["cpu"])
    want = {k: 0 for k in launches["cuda"]}
    want["rg_lru_scan"] = n_rec
    ok = (bool(torch.isfinite(logits["cuda"]).all()) and err <= 5e-2
          and h_err <= 5e-3 and launches["cuda"] == want
          and not any(launches["cpu"].values()))
    log("reference", path="griffin", model=cfg.name,
        steps=f"prefill({S} tokens, window {cfg.local_window})+{n_dec}decode",
        max_abs_err=f"{err:.6g}",
        logit_scale=f"{float(logits['cpu'].abs().max()):.6g}",
        state_max_abs_err=f"{h_err:.6g}",
        tolerance="logits 5e-2, recurrent state 5e-3",
        kernel_launches=",".join(f"{k}:{v}" for k, v in
                                 launches["cuda"].items()), ok=ok)
    if not ok:
        raise SystemExit("reduced Griffin on the card disagrees with the CPU "
                         "path")


# ---------------------------------------------------------------------------
# phase roofline: the analytic roofline beside the measured decode step
# ---------------------------------------------------------------------------

def roofline_phase() -> None:
    """``repro_torch.roofline``'s analytic report of Mixtral-8x7B at 8 and
    32 layers (one replica slot per rank, as the EP engine runs) for the
    main trace's decode step and a 512-token prefill; then phase 4's EP
    decode step p50 as a share of the card's peak for the step's model
    FLOPs, and the roofline's memory time beside the step's device busy
    time (both "not measured" without phase main)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.roofline import PEAK_FLOPS, analyze, model_flops

    base = get_config("mixtral-8x7b")
    shapes = (InputShape("main_decode", MAIN_CCFG["max_len"],
                         MAIN_CCFG["max_slots"], "decode"),
              InputShape("main_prefill", MAIN_CCFG["prefill_len"], 1,
                         "prefill"))
    reports = {}
    for layers in (MAIN_LAYERS, base.num_layers):
        cfg = dataclasses.replace(base, num_layers=layers, moe=dataclasses
                                  .replace(base.moe,
                                           duplication_slots=DUP_SLOTS))
        for shape in shapes:
            r = analyze(f"{cfg.name}-{layers}L", shape, "1x1", 1, cfg)
            reports[(layers, shape.name)] = (r, cfg, shape)
            log("roofline", **{k: (f"{v:.6g}" if isinstance(v, float)
                                   else v) for k, v in r.row().items()
                               if k != "collective_breakdown"})
    r, cfg, shape = reports[(MAIN_LAYERS, "main_decode")]
    step = MEASURED.get("serve/ep")
    prof = MEASURED.get("profile/store")
    if step is None or prof is None:
        log("roofline", decode_step="not measured (phase main not run)")
        return
    p50_s = step["step_p50_ms"] / 1e3
    log("roofline", cell="main trace EP decode step (8 of 32 layers)",
        model_flops=f"{model_flops(cfg, shape):.6g}",
        step_p50_ms=f"{step['step_p50_ms']:.4f}",
        model_flops_share_of_peak=f"{model_flops(cfg, shape) / (p50_s * PEAK_FLOPS):.6g}",
        roofline_memory_ms=f"{r.memory_s * 1e3:.4f}",
        roofline_compute_ms=f"{r.compute_s * 1e3:.4f}",
        device_busy_ms=f"{prof['busy_ms']:.4f}",
        decode_step_ms=f"{prof['step_ms']:.4f}",
        memory_share_of_busy=f"{r.memory_s * 1e3 / prof['busy_ms']:.4f}",
        memory_share_of_step=f"{r.memory_s * 1e3 / prof['step_ms']:.4f}",
        peaks="H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s")


# ---------------------------------------------------------------------------
# phase profile: ContinuousEngine.profile_phases at full width
# ---------------------------------------------------------------------------

PROFILE_LAYERS = 2                 # keeps the fp32 migrate inputs ~34 GB
PROFILE_ITERS = 3
PROFILE_SPANS = ("attn", "route", "pack", "a2a", "ffn", "combine", "migrate")


def _track_spans(tracer, track: str):
    doc = tracer.to_chrome()
    tids = {e["tid"] for e in doc["traceEvents"] if e.get("ph") == "M"
            and e.get("name") == "thread_name"
            and e["args"]["name"] == track}
    return [e["name"] for e in doc["traceEvents"]
            if e.get("ph") == "X" and e["tid"] in tids]


def dispatch_profile_phase(seed: int) -> None:
    """``profile_phases`` at the prefill bucket and decode-shaped on an EP
    store engine over 2 full-width Mixtral layers, with its checks; the
    packers and paged attention head to head; the ffn phase beside phase
    3's moe_gemm rows and the phases' sum over 8 layers beside phase 4's
    profiled EP decode step."""
    from repro_torch.kernels import ops
    from repro_torch.moe import profile as prof
    from repro_torch.obs import SpanTracer
    from repro_torch.serve import ContinuousConfig, ContinuousEngine

    t0 = time.perf_counter()
    free_engines("phases")
    model, cfg = build_mixtral(seed, PROFILE_LAYERS, phase="phases")
    tracer = SpanTracer()
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**MAIN_CCFG),
                           ep_ranks=EP_RANKS, ep=True, tracer=tracer)
    ccfg, m = eng.ccfg, eng.moe_cfg
    log("phases", layers=cfg.num_layers, ep_ranks=EP_RANKS,
        dup_slots=m.duplication_slots, iters=PROFILE_ITERS,
        dispatch_dtype="float32 (the JAX profile's)",
        allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    failures, profiles = [], {}
    for shape, tokens in (("prefill", ccfg.prefill_len),
                          ("decode", ccfg.max_slots)):
        if shape == "decode":
            eng.metrics.reset_phases()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        ph = eng.profile_phases(iters=PROFILE_ITERS, tokens=tokens)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        profiles[shape] = ph
        log("phases", shape=shape, tokens=tokens,
            **{f"{k}_s": f"{v:.6g}" for k, v in ph.items()},
            call_s=f"{time.perf_counter() - t1:.3f}",
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
            launches=",".join(f"{k}:{v}" for k, v in launches.items()))
        # each timed phase runs its callable once in the chain, once warm
        # and PROFILE_ITERS times; attn has no chain run
        want = {k: 0 for k in launches}
        want.update(paged_decode_attention=PROFILE_ITERS + 1,
                    fused_topk_route=PROFILE_ITERS + 2,
                    histogram_offsets=PROFILE_ITERS + 2,
                    moe_gemm=PROFILE_ITERS + 2)
        if launches != want:
            failures.append(f"{shape}: launches {launches} != {want}")
        keys = {"attn", "route", "pack", "a2a", "ffn", "combine", "total",
                "migrate", "prefetch"}
        if set(ph) != keys or not all(v > 0 for v in ph.values()):
            failures.append(f"{shape}: phases {ph}")
        dispatch = sum(ph[p] for p in prof.PHASES)
        if ph.get("total") != dispatch:
            failures.append(f"{shape}: total {ph.get('total')} != {dispatch}")
        cols = {k for k in eng.metrics.summary() if k.startswith("phase_")}
        if cols != {f"phase_{k}_us" for k in keys}:
            failures.append(f"{shape}: summary columns {sorted(cols)}")
    spans = _track_spans(tracer, "dispatch-profile")
    log("phases", dispatch_profile_spans=len(spans),
        span_order_ok=spans == list(PROFILE_SPANS) * 2)
    if spans != list(PROFILE_SPANS) * 2:
        failures.append(f"dispatch-profile spans {spans}")
    dev = model.device
    del eng, model, tracer
    free_engines("phases")

    packs = prof.pack_impl_times(d_model=cfg.d_model,
                                 num_experts=cfg.moe.num_experts,
                                 top_k=cfg.moe.top_k, tokens=ccfg.prefill_len,
                                 device=dev)
    attns = prof.attn_impl_times(
        batch=ccfg.max_slots, num_kv=cfg.num_kv_heads,
        gqa=cfg.num_heads // cfg.num_kv_heads, head_dim=cfg.head_dim,
        block_size=ccfg.block_size,
        max_blocks=ccfg.max_len // ccfg.block_size,
        window=cfg.sliding_window, device=dev)
    log("phases", head_to_head="pack", tokens=ccfg.prefill_len,
        **{f"{k}_ms": f"{v * 1e3:.4f}" for k, v in packs.items()},
        onehot_over_sort=f"{packs['onehot'] / packs['sort']:.3f}")
    log("phases", head_to_head="paged attention", batch=ccfg.max_slots,
        **{f"{k}_ms": f"{v * 1e3:.4f}" for k, v in attns.items()},
        gather_over_fused=f"{attns['gather'] / attns['fused']:.3f}")
    # phase 3 times its bf16 rows (the engine's arithmetic) and bounds its
    # fp32 rows (the profile's), at 12 slots of 8 / 128 rows
    rows = MEASURED.get("moe_gemm_rows", {})
    for shape in ("decode", "prefill"):
        fp32, bf16 = rows.get(f"float32/{shape}"), rows.get(
            f"bfloat16/{shape}")
        log("phases", compare="ffn phase vs kernel table", shape=shape,
            ffn_phase_fp32_ms=f"{profiles[shape]['ffn'] * 1e3:.4f}",
            ffn_phase_timer=f"host wall, best of {PROFILE_ITERS}, "
                            "synchronised",
            **({"moe_gemm_fp32_row_bound_ms": f"{fp32['bound_ms']:.4f}",
                "moe_gemm_fp32_row_bound_by": fp32["bound_by"],
                "moe_gemm_bf16_row_ms": f"{bf16['ms']:.4f}",
                "row_timer": "CUDA events, median of 25, L2 flushed"}
               if fp32 and bf16 else
               {"moe_gemm_rows": "not measured (phase moe_gemm not run)"}))
    dec = profiles["decode"]
    per_layer = dec["attn"] + dec["total"]
    step = MEASURED.get("profile/store")
    log("phases", compare="decode phases vs phase 4's EP decode step",
        phases_per_layer_ms=f"{per_layer * 1e3:.4f}",
        phases_x_layers_ms=f"{per_layer * 1e3 * MAIN_LAYERS:.4f}",
        layers=MAIN_LAYERS,
        **({"ep_decode_device_busy_ms": f"{step['busy_ms']:.4f}",
            "ep_decode_step_ms": f"{step['step_ms']:.4f}",
            "step_minus_phases_ms":
                f"{step['step_ms'] - per_layer * 1e3 * MAIN_LAYERS:.4f}"}
           if step else {"ep_decode_step": "not measured (phase main not "
                                           "run)"}))
    if failures:
        raise SystemExit("profile phase failed: " + "; ".join(failures))
    log("phases", phase_s=f"{time.perf_counter() - t0:.3f}")


# ---------------------------------------------------------------------------
# phase fleet: two full-width Mixtral instances under one arbiter
# ---------------------------------------------------------------------------

FLEET_LAYERS = 4                   # two stores of 2 replica slots: ~68 GB
# the JAX package's fleet A/B (benchmarks/bench_serve_traces.py) with the
# prompt bucket and length budget of its lever A/B, so that no prompt is
# cut; 12 of the 48 pool blocks each, the A/B's 12 blocks
FLEET_CCFG = dict(max_slots=4, prefill_len=64, block_size=8, max_len=96,
                  strategy="dist_only", predict_interval=4, dup_slots=2,
                  metrics_window=4, max_prefills_per_step=2)
FLEET_KV_QUOTA, FLEET_DUP_QUOTA = 12, 1
FLEET_ARBITER = dict(window_iters=8, patience=2, queue_norm=4.0,
                     kv_blocks_per_move=4, kv_floor_blocks=4)
FLEET_TRACE = dict(horizon=20.0, rate=1.2)
FLEET_DT, FLEET_MAX_ITERS = 0.25, 320


def fleet_leg(model, cfg, trace, label: str, arbiter: bool):
    """One leg of the fleet A/B; returns its summary row."""
    from repro_torch.fleet import (BATCH, ArbiterConfig, FleetAdmission,
                                   FleetEngine, FleetModelSpec, SLOClass)
    from repro_torch.kernels import ops
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.serve import ContinuousConfig
    from repro_torch.workloads import to_serve_requests

    adm = FleetAdmission(routes={"chat": "m-chat", "batch": "m-batch"},
                         slos={"chat": SLOClass("chat", slo_ttft=2.0,
                                                slo_tpot=1.0),
                               "batch": BATCH})
    ccfg = ContinuousConfig(**FLEET_CCFG)
    specs = [FleetModelSpec(n, cfg, model, ccfg,
                            dup_slot_quota=FLEET_DUP_QUOTA,
                            kv_block_quota=FLEET_KV_QUOTA)
             for n in ("m-chat", "m-batch")]
    t0 = time.perf_counter()
    fleet = FleetEngine(specs, ep=True, ep_ranks=EP_RANKS, admission=adm,
                        arbiter_cfg=ArbiterConfig(**FLEET_ARBITER),
                        enable_arbiter=arbiter, trace=True,
                        device=model.device)
    fleet.warmup()
    stores = [e._store.device_bytes for e in fleet.engines.values()]
    log("fleet", leg=label, build_and_warmup_s=f"{time.perf_counter() - t0:.3f}",
        store_device_gb=",".join(f"{b / 1e9:.3f}" for b in stores),
        allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}",
        kv_pool_blocks=ccfg.num_blocks - 1,
        hardware=ArbiterConfig().hardware.name)
    reqs = to_serve_requests(trace)
    for r in sorted(reqs, key=lambda r: r.arrival):
        fleet.submit(r)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    now, n, over_quota = 0.0, 0, []
    t0 = time.perf_counter()
    while fleet.has_work() and n < FLEET_MAX_ITERS:
        fleet.step(now)
        now += FLEET_DT
        n += 1
        over_quota += [(n, name) for name, e in fleet.engines.items()
                       if e.allocator.in_use > e.allocator.quota]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for eng in fleet.engines.values():
        eng.metrics.flush(eng._plan_stack, eng.ep_ranks,
                          eng.moe_cfg.duplication_slots)
    s = fleet.summary()
    failures = []
    want = {k: 0 for k in launches}
    done = 0
    for name, eng in fleet.engines.items():
        es = eng.metrics.summary()
        prefills = len(eng.scheduler.completed) + int(es["preemptions"])
        part = expected_launches(launches, cfg, prefills, eng.decode_steps,
                                 ep=True)
        want = {k: want[k] + part[k] for k in want}
        done += len(eng.scheduler.completed)
        for r in eng.scheduler.completed:
            toks = np.asarray(r.generated)
            if len(toks) != r.max_new_tokens or (toks < 0).any() \
                    or (toks >= cfg.vocab_size).any():
                failures.append(f"{name} request {r.rid}: bad tokens")
        log("fleet", leg=label, model=name,
            completed=len(eng.scheduler.completed), prefills=prefills,
            decode_steps=eng.decode_steps,
            attainment=f"{adm.model_attainment(eng.metrics, name):.4f}",
            ttft_p50_s=f"{es['ttft_p50']:.4f}", ttft_p99_s=f"{es['ttft_p99']:.4f}",
            replans=int(es["replans"]),
            migration_commits=int(es["migration_commits"]),
            dup_slot_quota=eng.dup_slot_quota,
            kv_block_quota=eng.allocator.quota)
    moves = fleet.arbiter.moves if fleet.arbiter else []
    row = {"fleet_slo_attainment": s["fleet_slo_attainment"],
           "fleet_slo_attainment_worst": s["fleet_slo_attainment_worst"],
           "moves": len(moves),
           "chat_kv_quota": int(s["m-chat_kv_block_quota"]),
           "batch_kv_quota": int(s["m-batch_kv_block_quota"]),
           "chat_dup_quota": int(s["m-chat_dup_slot_quota"]),
           "batch_dup_quota": int(s["m-batch_dup_slot_quota"]),
           "fleet_step_p50_ms": s["fleet_step_p50_ms"],
           "fleet_step_p99_ms": s["fleet_step_p99_ms"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("fleet", leg=label, requests=len(reqs), completed=done,
        iterations=n, drained=not fleet.has_work(), wall_s=f"{wall:.3f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        **{k: (f"{v:.4f}" if isinstance(v, float) else v)
           for k, v in row.items()})
    for mv in moves:
        log("fleet", leg=label, move=f"'{mv.explain()}'")
    if fleet.has_work():
        failures.append(f"not drained after {n} iterations")
    if done != len(reqs):
        failures.append(f"{done} of {len(reqs)} requests completed")
    if launches != want:
        failures.append(f"kernel launches {launches} != {want}")
    if (row["chat_kv_quota"] + row["batch_kv_quota"] != 2 * FLEET_KV_QUOTA
            or row["chat_dup_quota"] + row["batch_dup_quota"]
            != 2 * FLEET_DUP_QUOTA):
        failures.append(f"ledger quotas {row} do not sum to the provisioned")
    if over_quota:
        failures.append(f"allocator above its quota at {over_quota[:4]}")
    doc = fleet.merged_trace()
    bad = validate_chrome_trace(doc)
    pids = {e["pid"] for e in doc["traceEvents"]}
    if bad or pids != {1, 2}:
        failures.append(f"merged trace: {bad[:3]}, pids {sorted(pids)}")
    if failures:
        raise SystemExit(f"fleet ({label}) failed: " + "; ".join(failures))
    return row


def fleet_phase(seed: int) -> None:
    """The fleet A/B at full width: a static leg and an arbiter leg over
    one shared 4-layer Mixtral."""
    from repro_torch.workloads import build_workload

    t0 = time.perf_counter()
    free_engines("fleet")
    model, cfg = build_mixtral(seed, FLEET_LAYERS, phase="fleet",
                               dup_slots=FLEET_CCFG["dup_slots"])
    trace = build_workload("fleet_shift", cfg.vocab_size, **FLEET_TRACE,
                           seed=seed)
    rows = {}
    for label, arbiter in (("static", False), ("arbiter", True)):
        rows[label] = fleet_leg(model, cfg, trace, label, arbiter)
        free_engines("fleet")
    if rows["arbiter"]["moves"] < 1 or rows["static"]["moves"] != 0:
        raise SystemExit(f"fleet: moves {rows['arbiter']['moves']} "
                         f"(arbiter) / {rows['static']['moves']} (static)")
    log("fleet", compare="arbiter vs static",
        attainment=f"{rows['arbiter']['fleet_slo_attainment']:.4f} vs "
                   f"{rows['static']['fleet_slo_attainment']:.4f}",
        attainment_worst=f"{rows['arbiter']['fleet_slo_attainment_worst']:.4f}"
                         f" vs {rows['static']['fleet_slo_attainment_worst']:.4f}",
        phase_s=f"{time.perf_counter() - t0:.3f}")
    del model
    free_engines("fleet")


# ---------------------------------------------------------------------------
# phase train: training full-width Mixtral (2 layers) and RecurrentGemma-2B
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 2                   # 16 B/param: 2 layers 50.6 GB, 3 73.9 GB
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 512, 10, 3e-4
# fresh moments and a small fixed lr: at the schedule's 3e-4 Adam's early
# steps (about lr per element along the gradient's sign, on every one of
# 3.2e9 weights) overshoot a repeated batch (PERF.md, training findings)
TRAIN_REPEAT_STEPS, TRAIN_REPEAT_LR = 3, 1e-5
GRIFFIN_TRAIN = dict(batch=2, seq=1024, steps=10)
CAPTURE_STEP = 5                   # the step whose layer-0 inputs are kept
# the card against the CPU: the CPU tests' tolerances (tests/test_torch_train.py)
TRAIN_REL = 1e-3
TRAIN_PROBE_REL = {"remat": 1e-6, "mb2": 1e-3}


class _BwdCapture:
    """Keeps a copy of the inputs of the last ``kernels.ops.<name>`` call of
    train step ``CAPTURE_STEP``, counting ``per_step`` calls a step (the
    backward walks the layers in reverse, so a step's last call is layer
    0's). Installed around the module's function, which the autograd
    ``Function``s call through the module."""

    def __init__(self, name: str, per_step: int):
        from repro_torch.kernels import ops

        self.ops, self.name, self.per_step = ops, name, per_step
        self.real = getattr(ops, name)
        self.calls = 0
        self.inputs = None

    def __enter__(self):
        def wrapped(*a):
            if self.calls // self.per_step == CAPTURE_STEP:
                self.inputs = tuple(t.clone() if torch.is_tensor(t) else t
                                    for t in a)
            self.calls += 1
            return self.real(*a)
        setattr(self.ops, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.real)


def _skew(counts) -> float:
    c = counts.float().sum(0)
    return float(c.max() / c.mean().clamp_min(1e-9))


def _train_kernel_case(kernel: str, cap: _BwdCapture, flush,
                       case: str = "train_step") -> None:
    """A backward kernel on one real train step's layer-0 inputs, held
    against its plain version at the kernel phase's check and timed as
    that phase times it; logged as the kernels line's ``case`` (its error
    joins the row's)."""
    if cap.inputs is None:
        raise SystemExit(f"train: no {kernel} call was captured")
    if kernel == "moe_gemm_bwd":
        x, wg, wu, wd, slot_map, dy, act, counts = cap.inputs
        row = moe_bwd_case(x, wg, wu, wd, slot_map, dy, act, counts, flush)
        S, T, d = x.shape
        _log_row(kernel, case, f"S{S}xT{T}xd{d}xF{wu.shape[-1]}/{act}", row)
        if not row["ok"]:
            raise SystemExit(f"{kernel} disagrees with its plain version on "
                             "a train step's inputs")
        k = KERNEL_ROWS.get(kernel)
        if k is not None:
            k["max_abs_err"] = max(k["max_abs_err"], row["max_abs_err"])
        cap.inputs = None
        return
    if kernel == "fused_topk_route_bwd":
        probs, idx, *grads = cap.inputs
        R, T, E = probs.shape
        K = idx.shape[-1]
        row = _route_bwd_check(probs, idx, grads)
        row["bound_ms"], row["bound_by"] = _route_bwd_bound(R, T, E, K)
        # the chain's logits: any whose softmax is probs
        row.update(_route_bwd_timed(probs, idx, grads, torch.log(probs),
                                    flush))
        shape = f"R{R}xT{T}xE{E}xK{K}"
    else:
        a, h_all, h0, *grads = cap.inputs
        B, S, D = a.shape
        row = _scan_bwd_check(a, h_all, h0, grads)
        row["bound_ms"], row["bound_by"] = _scan_bwd_bound(B, S, D)
        row.update(_scan_bwd_timed(a, h_all, h0, grads, flush))
        shape = f"B{B}xS{S}xD{D}"
    row["gradients"] = "".join("-" if g is None else "y" for g in grads)
    _log_row(kernel, case, shape, row)
    if not row["ok"]:
        raise SystemExit(f"{kernel} disagrees with its plain version on a "
                         "train step's inputs")
    if kernel in KERNEL_ROWS:
        k = KERNEL_ROWS[kernel]
        k["max_abs_err"] = max(k["max_abs_err"], row["max_abs_err"])
    cap.inputs = None


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "sm90_")


def train_breakdown(label: str, cfg, model, opt, batch, rt=None,
                    plan=None, remat: bool = False) -> dict:
    """Where a train step's time goes, at the model's current weights: the
    forward and backward (``make_loss_fn`` under ``rt``, default the single
    device's, then ``backward``) under torch.profiler, its device time split
    into matrix products (cuBLAS kernels by name), the router's and the
    scan's kernels (forward and backward), ``moe_gemm`` and
    ``moe_gemm_bwd`` (with the latter's share of busy time) and the rest;
    the forward and backward and the AdamW update (``adamw_update_`` at lr
    0, which leaves the weights as they are) each by CUDA events. The
    update's moments move; nothing else changes. ``remat``: the forward
    and backward with each layer recomputed, as the run took it. The
    device times are NaN when no profiler session kept them."""
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim.adamw import adamw_update_
    from repro_torch.train.steps import (make_loss_fn, param_tree,
                                         weight_decay_mask)

    loss_fn = make_loss_fn(cfg, rt or Runtime(), remat)
    params = param_tree(model)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    def fwd_bwd():
        for p in params.values():
            p.grad = None
        loss, _ = loss_fn(model, batch, plan)
        loss.backward()
    fwd_bwd()
    torch.cuda.synchronize()
    prof, _ = profiled(fwd_bwd, f"the {label} train step")
    kernels = {} if prof is None else _kernel_time_by_name(prof, 1)
    split = dict.fromkeys(("gemm", "router", "scan", "moe_gemm",
                           "moe_gemm_bwd", "other"),
                          0.0 if kernels else NOT_MEASURED)
    for name, (ms, _) in kernels.items():
        low = name.lower()
        key = ("router" if "topk_route" in low else "scan" if "rg_lru" in low
               else "moe_gemm_bwd" if "moe_bwd_" in low
               else "moe_gemm" if "moe_gemm" in low
               else "gemm" if any(g in low for g in GEMM_NAMES) else "other")
        split[key] += ms
    events = []
    for fn in (fwd_bwd, lambda: adamw_update_(
            params, {n: p.grad for n, p in params.items()}, opt, 0.0,
            decay=weight_decay_mask(model))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end))
    for p in params.values():
        p.grad = None
    busy = sum(split.values())
    row = dict(fwd_bwd_device_busy_ms=busy,
               **{f"{k}_ms": v for k, v in split.items()},
               gemm_share=split["gemm"] / busy,
               moe_gemm_bwd_share=split["moe_gemm_bwd"] / busy,
               fwd_bwd_ms=events[0], adamw_ms=events[1])
    log("train", run=label, breakdown="one step at these weights",
        **{k: f"{v:.4f}" for k, v in row.items()},
        top_kernels=";".join(f"{n[:40]}:{ms:.2f}" for n, (ms, _) in sorted(
            kernels.items(), key=lambda kv: -kv[1][0])[:5]).replace(" ", ""))
    return row


def mixtral_train_run(seed: int, flush) -> dict:
    """Mixtral-8x7B at published widths, 2 of its 32 layers, fp32 weights
    (``trainable=True``) from ``seed``: ``TRAIN_STEPS`` steps of
    ``make_train_step`` on 4 x 512 Zipf batches (``token_batches(seed)``)
    at the launcher's schedule (``build_lr_fn``, base lr 3e-4), the single-
    device MoE path. Per step: loss, aux loss, gradient norm, lr, window
    skew of the expert counts, step ms (host clock, synchronised). Then, at
    fixed weights (lr 0), one batch through the plain step, ``remat`` and
    2 microbatches (their losses held together), ``train_breakdown``, and
    ``TRAIN_REPEAT_STEPS``
    steps on one batch at a fixed lr from fresh moments, whose loss must
    fall. Returns the launches of the timed run."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_lr_fn
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.train.steps import init_opt_state, make_train_step

    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=TRAIN_LAYERS)
    n_params = cfg.num_params()
    log("train", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        d_ff_expert=cfg.moe.d_ff_expert, vocab=cfg.vocab_size,
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, moe_path="moe_ffn_dense (single device)",
        reduced=f"num_layers 32->{TRAIN_LAYERS}: 16 B/param of fp32 weights, "
                "gradients and two moments, 2 layers 50.6 GB, 3 layers "
                "73.9 GB before activations")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda", trainable=True)
    opt = init_opt_state(model)
    torch.cuda.synchronize()
    log("train", init_s=f"{time.perf_counter() - t0:.3f}",
        weights_and_moments_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    rt = Runtime()
    L = cfg.num_layers
    step = make_train_step(cfg, rt, lr_fn=build_lr_fn(cfg, TRAIN_LR,
                                                      TRAIN_STEPS))
    gen = token_batches(seed, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _BwdCapture("fused_topk_route_bwd", L) as cap:
        for i in range(TRAIN_STEPS):
            batch = next(gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt, m = step(model, opt, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            log("train", run="mixtral", step=i, loss=f"{losses[-1]:.6f}",
                aux_loss=f"{float(m['aux_loss']):.6g}",
                z_loss_in_loss="yes", nll=f"{float(m['nll']):.6f}",
                grad_norm=f"{float(m['grad_norm']):.6g}",
                lr=f"{float(m['lr']):.6g}",
                skew=f"{_skew(m['expert_counts']):.4f}",
                step_ms=f"{step_ms[-1]:.3f}")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p50 = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mflops = model_flops(cfg, InputShape("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    want = {k: 0 for k in launches}
    want.update(fused_topk_route=L * TRAIN_STEPS,
                fused_topk_route_bwd=L * TRAIN_STEPS)
    log("train", run="mixtral", steps=TRAIN_STEPS,
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
        step_ms_p50=f"{p50:.3f}", step_ms_first=f"{step_ms[0]:.3f}",
        tokens_per_s=f"{tokens / p50 * 1e3:.2f}", peak_gb=f"{peak_gb:.3f}",
        model_flops_per_step=f"{mflops:.6g}",
        model_flops_share_of_peak=f"{mflops / (p50 / 1e3 * PEAK_FLOPS):.6g}",
        note="6 x active params x tokens; the dense path computes all 8 "
             "experts per token, 4x the active expert FLOPs",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    failures = []
    if launches != want:
        failures.append(f"launches {launches} != {want}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        failures.append(f"loss {losses[0]} -> {losses[-1]}")
    _train_kernel_case("fused_topk_route_bwd", cap, flush)

    # the same weights (lr 0 leaves them unchanged) through the three
    # variants of the step on one batch
    batch = next(gen)
    probe = {}
    for name, kw, fwd, bwd in (("plain", {}, L, L),
                               ("remat", dict(remat=True), 2 * L, L),
                               ("mb2", dict(microbatches=2), 2 * L, 2 * L)):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        opt, m = make_train_step(cfg, rt, lr_fn=lambda s: 0.0, **kw)(
            model, opt, batch)
        torch.cuda.synchronize()
        probe[name] = m
        got = dict(ops.LAUNCHES)
        ok_l = got == dict(want, fused_topk_route=fwd,
                           fused_topk_route_bwd=bwd)
        log("train", run="mixtral", probe=name, loss=f"{float(m['loss']):.8f}",
            nll=f"{float(m['nll']):.8f}",
            grad_norm=f"{float(m['grad_norm']):.8g}",
            step_ms=f"{(time.perf_counter() - t1) * 1e3:.3f}",
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
            launches_ok=ok_l)
        if not ok_l:
            failures.append(f"{name} launches {got}")
    for name, rel in TRAIN_PROBE_REL.items():
        a, b = float(probe[name]["loss"]), float(probe["plain"]["loss"])
        ok = abs(a - b) <= rel * abs(b)
        log("train", run="mixtral", compare=f"{name} vs plain",
            loss_rel_diff=f"{abs(a - b) / abs(b):.3g}", tolerance=rel, ok=ok)
        if not ok:
            failures.append(f"{name} loss {a} vs plain {b}")

    train_breakdown("mixtral", cfg, model, opt, batch)

    # gradients move the model: one batch again and again at a fixed lr,
    # from fresh moments (the old ones freed first: 25 GB)
    batch = next(gen)
    del opt
    opt = init_opt_state(model)
    rep = make_train_step(cfg, rt, lr_fn=lambda s: TRAIN_REPEAT_LR)
    rl = []
    for _ in range(TRAIN_REPEAT_STEPS + 1):
        opt, m = rep(model, opt, batch)
        rl.append(float(m["loss"]))
    log("train", run="mixtral", repeat_batch_losses=",".join(
        f"{v:.6f}" for v in rl), lr=TRAIN_REPEAT_LR, falls=rl[-1] < rl[0])
    if not rl[-1] < rl[0]:
        failures.append(f"the repeated batch's loss did not fall: {rl}")
    if failures:
        raise SystemExit("train (mixtral) failed: " + "; ".join(failures))
    del model, opt, m, probe
    gc.collect()
    torch.cuda.empty_cache()
    return launches


TRAIN_EP_KERNELS = ("fused_topk_route", "fused_topk_route_bwd",
                    "histogram_offsets", "moe_gemm", "moe_gemm_bwd")


def _train_ep_cfg(capacity_factor=None):
    """Full-width Mixtral cut to ``TRAIN_LAYERS`` layers for the EP runs,
    without replica slots (the JAX launcher's ``use_duplication=False``),
    at its own capacity factor (1.25) or the one given."""
    from repro_torch.configs.registry import get_config

    base = get_config("mixtral-8x7b")
    moe = dataclasses.replace(base.moe, duplication_slots=0)
    if capacity_factor is not None:
        moe = dataclasses.replace(moe, capacity_factor=capacity_factor)
    return dataclasses.replace(base, num_layers=TRAIN_LAYERS, moe=moe)


def mixtral_ep_train_run(seed: int, flush) -> dict:
    """Mixtral-8x7B at published widths, ``TRAIN_LAYERS`` layers, fp32
    weights from ``seed``, through the expert-parallel dispatch:
    ``Runtime(ep=True, ep_ranks=EP_RANKS)``, the identity plan stack,
    capacity factor 1.25, ``TRAIN_STEPS`` steps of ``make_train_step`` on
    4 x 512 Zipf batches at the launcher's schedule. Per step: loss, aux
    loss, gradient norm, dropped pairs, step ms; then step p50, tokens/s,
    peak memory, exact launches of the EP kernels (one of each per layer
    and step), ``train_breakdown`` with ``moe_gemm_bwd``'s share, and the
    kernel on one real step's layer-0 inputs against its plain version.
    The loss must fall. Returns the launches of the timed run."""
    from repro_torch.core.placement import identity_plan, stack_plans, to_device
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_lr_fn
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.train.steps import init_opt_state, make_train_step

    cfg = _train_ep_cfg()
    m_cfg, L = cfg.moe, cfg.num_layers
    rt = Runtime(ep=True, ep_ranks=EP_RANKS)
    plan = to_device(stack_plans([identity_plan(
        m_cfg.num_experts, EP_RANKS, 0, m_cfg.max_copies)] * L),
        m_cfg.num_experts, EP_RANKS, 0, "cuda")
    log("train", run="mixtral_ep", model=cfg.name, layers=L,
        ep_ranks=EP_RANKS, capacity_factor=m_cfg.capacity_factor,
        plan="identity (no replica slots)", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, moe_path="ep_moe_ffn (moe_gemm + moe_gemm_bwd)")
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda", trainable=True)
    opt = init_opt_state(model)
    step = make_train_step(cfg, rt, lr_fn=build_lr_fn(cfg, TRAIN_LR,
                                                      TRAIN_STEPS))
    gen = token_batches(seed, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    losses, step_ms, drops = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _BwdCapture("moe_gemm_bwd", L) as cap:
        for i in range(TRAIN_STEPS):
            batch = next(gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt, m = step(model, opt, batch, plan)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            drops.append(int(m["dropped"].sum()))
            log("train", run="mixtral_ep", step=i, loss=f"{losses[-1]:.6f}",
                aux_loss=f"{float(m['aux_loss']):.6g}",
                grad_norm=f"{float(m['grad_norm']):.6g}",
                lr=f"{float(m['lr']):.6g}", dropped_pairs=drops[-1],
                dropped_per_layer=",".join(
                    str(int(v)) for v in m["dropped"].tolist()),
                skew=f"{_skew(m['expert_counts']):.4f}",
                step_ms=f"{step_ms[-1]:.3f}")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p50 = float(np.median(step_ms[1:]))
    want = {k: 0 for k in launches}
    want.update({k: L * TRAIN_STEPS for k in TRAIN_EP_KERNELS})
    pairs = TRAIN_BATCH * TRAIN_SEQ * m_cfg.top_k * L
    log("train", run="mixtral_ep", steps=TRAIN_STEPS,
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
        step_ms_p50=f"{p50:.3f}", step_ms_first=f"{step_ms[0]:.3f}",
        tokens_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}",
        dropped_pairs_per_step=",".join(map(str, drops)),
        dropped_share=f"{np.mean(drops) / pairs:.4f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        launches_ok=launches == want)
    failures = []
    if launches != want:
        failures.append(f"launches {launches} != {want}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        failures.append(f"loss {losses[0]} -> {losses[-1]}")
    _train_kernel_case("moe_gemm_bwd", cap, flush)
    train_breakdown("mixtral_ep", cfg, model, opt, next(gen), rt, plan)
    if failures:
        raise SystemExit("train (mixtral_ep) failed: " + "; ".join(failures))
    del model, opt, m
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def ep_vs_dense_check(seed: int) -> None:
    """One batch through the EP and the single-device loss of one fresh
    model (no optimizer moments: two 2-layer trainable models with theirs
    would need 101 GB) at capacity factor E / K, where a slot's capacity is
    the rank's token count and nothing drops: the losses within
    ``TRAIN_REL``, every gradient leaf within 3e-2 relative in norm (the
    CPU test's tolerances: the dense path's cuBLAS products round ``g`` and
    ``u`` to bf16 where ``moe_gemm`` keeps them fp32)."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.train.steps import make_loss_fn

    base = _train_ep_cfg()
    cfg = _train_ep_cfg(base.moe.num_experts / base.moe.top_k)
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda", trainable=True)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(
        token_batches(seed + 1, cfg.vocab_size, TRAIN_BATCH,
                      TRAIN_SEQ)).items()}
    res = {}
    t0 = time.perf_counter()
    for name, rt in (("ep", Runtime(ep=True, ep_ranks=EP_RANKS)),
                     ("dense", Runtime())):
        loss, m = make_loss_fn(cfg, rt)(model, batch)
        loss.backward()
        res[name] = (float(loss), {n: p.grad for n, p in
                                   model.named_parameters()},
                     int(m["dropped"].sum()) if "dropped" in m else 0)
        for p in model.parameters():
            p.grad = None
    torch.cuda.synchronize()
    (le, ge, dropped), (ld, gd, _) = res["ep"], res["dense"]
    worst = max((float((ge[n] - gd[n]).norm() / gd[n].norm().clamp_min(1e-30)),
                 n) for n in gd)
    ok = (dropped == 0 and abs(le - ld) <= TRAIN_REL * abs(ld)
          and worst[0] <= 3e-2)
    log("train", ep_vs_dense=cfg.name, capacity_factor=cfg.moe.capacity_factor,
        loss_ep=f"{le:.6f}", loss_dense=f"{ld:.6f}", dropped=dropped,
        worst_grad_rel=f"{worst[0]:.4g}", worst_leaf=worst[1],
        tolerance=f"loss {TRAIN_REL} rel; each gradient 3e-2 rel in norm",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        seconds=f"{time.perf_counter() - t0:.3f}", ok=ok)
    del model, ge, gd, res
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("the EP train step disagrees with the dense one "
                         "where nothing drops")


def griffin_train_run(seed: int, flush) -> dict:
    """RecurrentGemma-2B as configured, all 26 layers, fp32 weights from
    ``seed``, through the command a user runs
    (``repro_torch.launch.train.main``): 10 steps of 2 x 1024 Zipf tokens at
    the launcher's schedule, one span per step in its trace. Its return
    code must be 0 (the last loss below the first); every recurrent layer of
    every step must launch the scan and its backward once. Then the same
    weights again for ``train_breakdown``. Returns the launches."""
    import contextlib
    import io

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg = get_config("recurrentgemma-2b")
    n_rec = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "recurrent"
                for i in range(cfg.num_layers))
    a = GRIFFIN_TRAIN
    trace = os.path.join(ROOT, "build", "chip_smoke", "griffin_train.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    argv = ["--arch", cfg.name, "--steps", str(a["steps"]),
            "--batch", str(a["batch"]), "--seq", str(a["seq"]),
            "--log-every", "1", "--seed", str(seed), "--device", "cuda",
            "--trace-out", trace]
    log("train", model=cfg.name, layers=cfg.num_layers,
        recurrent_layers=n_rec, params=cfg.num_params(),
        reduced="none (published widths, all 26 layers; 43.3 GB of fp32 "
                "weights, gradients and moments)",
        argv=f"'{' '.join(argv)}'")
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _BwdCapture("rg_lru_scan_bwd", n_rec) as cap:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = launch_train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lines = out.getvalue().splitlines()
    for line in lines:
        log("train", run="griffin", stdout=f"'{line}'")
    with open(trace) as f:
        spans = [e["dur"] / 1e3 for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e["name"] == "train_step"]
    p50 = float(np.median(spans[1:]))
    tokens = a["batch"] * a["seq"]
    from repro_torch.configs.base import InputShape
    from repro_torch.roofline import PEAK_FLOPS, model_flops
    mflops = model_flops(cfg, InputShape("train", a["seq"], a["batch"],
                                         "train"))
    want = {k: 0 for k in launches}
    want.update(rg_lru_scan=n_rec * a["steps"],
                rg_lru_scan_bwd=n_rec * a["steps"])
    log("train", run="griffin", rc=rc, wall_s=f"{wall:.3f}",
        step_ms=",".join(f"{v:.3f}" for v in spans),
        step_ms_p50=f"{p50:.3f}", tokens_per_s=f"{tokens / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}", model_flops_per_step=f"{mflops:.6g}",
        model_flops_share_of_peak=f"{mflops / (p50 / 1e3 * PEAK_FLOPS):.6g}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    failures = []
    if rc != 0:
        failures.append(f"launch.train exit {rc} (the loss did not fall)")
    if len(spans) != a["steps"]:
        failures.append(f"{len(spans)} step spans")
    if launches != want:
        failures.append(f"launches {launches} != {want}")
    _train_kernel_case("rg_lru_scan_bwd", cap, flush)
    if failures:
        raise SystemExit("train (griffin) failed: " + "; ".join(failures))
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher's weights again (its model is gone with main's frame)
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.train.steps import init_opt_state

    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda", trainable=True)
    opt = init_opt_state(model)
    train_breakdown("griffin", cfg, model, opt, next(token_batches(
        seed, cfg.vocab_size, a["batch"], a["seq"])))
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_card_vs_cpu(seed: int) -> None:
    """One train step of reduced Mixtral (router weights x 25, as the
    reference phase, so routes stand clear of the two devices' bf16 noise)
    on the single-device path and through the EP dispatch (4 ranks, the
    identity plan), and of reduced Griffin, on the card (kernels) and on the
    CPU (plain versions) from the same bridged fp32 weights and batch: loss
    and gradient norm within ``TRAIN_REL``, the updated parameters within 2
    lr with at most 2% of a leaf's elements beyond lr / 10 (the CPU tests'
    tolerances against the JAX step); the card's launches counted."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.steps import init_opt_state, make_train_step

    lr = 1e-3
    failures = []
    for arch, rt in (("mixtral-8x7b", Runtime()),
                     ("mixtral-8x7b", Runtime(ep=True, ep_ranks=EP_RANKS)),
                     ("recurrentgemma-2b", Runtime())):
        cfg = get_config(arch).reduced()
        gpu = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda", trainable=True)
        if cfg.is_moe:
            with torch.no_grad():
                for layer in gpu.layers:
                    layer.router.mul_(25.0)
        cpu = params_from_jax(params_to_jax(gpu), cfg, device="cpu",
                              trainable=True)
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        res = {}
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            ops.reset_launches()
            _, m = make_train_step(cfg, rt, lr_fn=lambda s: lr)(
                model, init_opt_state(model), batch)
            res[name] = (float(m["loss"]), float(m["grad_norm"]),
                         flatten(params_to_jax(model)), dict(ops.LAUNCHES))
        (lg, ng, pg, launches), (lc, nc, pc, cpu_l) = res["cuda"], res["cpu"]
        worst, beyond = 0.0, 0.0
        for key, want in pc.items():
            d = np.abs(pg[key] - want)
            worst = max(worst, float(d.max()))
            beyond = max(beyond, float((d > lr / 10).mean()))
        n_rec = sum(layer.kind == "recurrent" for layer in gpu.layers)
        want_l = {k: 0 for k in launches}
        if rt.ep:
            want_l.update({k: cfg.num_layers for k in TRAIN_EP_KERNELS})
        elif cfg.is_moe:
            want_l.update(fused_topk_route=cfg.num_layers,
                          fused_topk_route_bwd=cfg.num_layers)
        else:
            want_l.update(rg_lru_scan=n_rec, rg_lru_scan_bwd=n_rec)
        ok = (abs(lg - lc) <= TRAIN_REL * abs(lc)
              and abs(ng - nc) <= TRAIN_REL * abs(nc)
              and worst <= 2 * lr + 1e-6 and beyond <= 0.02
              and launches == want_l and not any(cpu_l.values()))
        log("train", card_vs_cpu=cfg.name, ep_ranks=rt.ep_ranks if rt.ep
            else 0, loss_cuda=f"{lg:.6f}",
            loss_cpu=f"{lc:.6f}", grad_norm_cuda=f"{ng:.6g}",
            grad_norm_cpu=f"{nc:.6g}", param_max_abs_diff=f"{worst:.6g}",
            share_beyond_lr_over_10=f"{beyond:.4g}",
            tolerance=f"loss and grad norm {TRAIN_REL} rel; params 2 lr, "
                      "<= 2% beyond lr/10",
            launches=",".join(f"{k}:{v}" for k, v in launches.items()),
            ok=ok)
        if not ok:
            failures.append(f"{cfg.name} (ep={rt.ep})")
    if failures:
        raise SystemExit(f"train step on the card disagrees with the CPU: "
                         f"{failures}")


def train_phase(seed: int) -> dict:
    """Phase ``train``: the full-width Mixtral runs (single-device, then
    EP), EP against dense where nothing drops, and Griffin, each run
    holding its backward kernel against the plain version on a real step's
    layer-0 inputs, then reduced models card against CPU. Returns the
    runs' launches (the EP kernels' from the EP run)."""
    t0 = time.perf_counter()
    free_engines("train")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    launches = mixtral_train_run(seed, flush)
    t1 = time.perf_counter()
    launches.update({k: v for k, v in mixtral_ep_train_run(seed, flush)
                     .items() if k in TRAIN_EP_KERNELS})
    ep_vs_dense_check(seed)
    log("train", ep_runs_s=f"{time.perf_counter() - t1:.3f}")
    launches.update({k: v for k, v in griffin_train_run(seed, flush).items()
                     if k.startswith("rg_lru")})
    del flush
    torch.cuda.empty_cache()
    train_card_vs_cpu(seed)
    log("train", phase_s=f"{time.perf_counter() - t0:.3f}")
    return launches


# ---------------------------------------------------------------------------
# phase models: the paper's other MoE models at published widths
# ---------------------------------------------------------------------------

MODEL_LAYERS = {"llama-moe-3.5b": 32, "switch-base-128": 12, "arctic-480b": 2}
MODEL_CUTS = {
    "llama-moe-3.5b": "none: all 32 layers (6.74e9 parameters, 13.5 GB bf16)",
    "switch-base-128": "none: all 12 layers (10.95e9 parameters held, the "
                       "experts' unread w_gate among them, 21.9 GB bf16)",
    "arctic-480b": "num_layers 35->2: 13.61e9 parameters a layer (27.2 GB "
                   "bf16); 2 layers with the embedding and the head 55.4 GB, "
                   "the store's 8 replica rows a layer 1.7 GB more, and "
                   "building a store holds one more weight's 136 rows (9.5 "
                   "GB) at a time; 3 layers would need 83 GB before the "
                   "store, more than the card's 80 GB"}
MODELS_CCFG = dict(max_slots=8, prefill_len=128, block_size=16, max_len=192,
                   strategy="dist_only", predict_interval=2,
                   dup_slots=DUP_SLOTS)
MODELS_TRACE = dict(requests=8, prompt=(32, 129), new_tokens=16, gap=0.02)
# the moe_gemm case of a real EP prefill's layer 0: arctic's plain version
# gathers 70 MB a matrix per slot, so it holds the first 8 slots only
MODELS_CASE_SLOTS = {"arctic-480b": 8}
MODELS_TRAIN = ("llama-moe-3.5b", "switch-base-128")
SERVING_KERNELS = ("paged_decode_attention", "fused_topk_route",
                   "histogram_offsets", "moe_gemm")


def _model_cfg(arch: str, layers: int):
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers)


def models_serve(arch: str, seed: int, smi: str) -> dict:
    """One of the paper's other MoE models at published widths, cut to
    ``MODEL_LAYERS`` layers (``MODEL_CUTS`` says why), random weights from
    ``seed``, through ``ContinuousEngine`` on ``MODELS_CCFG`` and a trace of
    ``MODELS_TRACE``: the dense path, then the EP path (4 ranks, one replica
    slot a rank, the replica store at the engine's defaults) under
    dist_only and under none. ``serve_trace`` checks completions, tokens
    and exact launches; per run a line with the card, step p50, decode
    tokens/s, peak memory, imbalance, drops and the four serving kernels'
    launches. The dist_only run's first prefill's layer-0 kernel inputs are
    held against the plain versions (the kernels line's ``models_<arch>``
    cases). Returns the launches of every run."""
    from repro_torch.models.transformer import init_model

    cfg = _model_cfg(arch, MODEL_LAYERS[arch])
    m = cfg.moe
    log("models", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, experts=m.num_experts, top_k=m.top_k,
        d_ff_expert=m.d_ff_expert, activation=cfg.activation,
        dense_residual=(m.d_ff_dense or cfg.d_ff) if m.dense_residual else 0,
        vocab=cfg.vocab_size, capacity_factor=m.capacity_factor,
        ep_ranks=EP_RANKS, dup_slots=DUP_SLOTS,
        reduced=f"'{MODEL_CUTS[arch]}'")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    log("models", model=cfg.name, init_s=f"{time.perf_counter() - t0:.3f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    out = {}
    for leg, ep, strategy in (("dense", False, "dist_only"),
                              ("ep", True, "dist_only"),
                              ("ep_none", True, "none")):
        label = f"{cfg.name}/{leg}"
        with (_PrefillCapture() if leg == "ep"
              else contextlib.nullcontext()) as cap:
            eng, launches = serve_trace(label, model, cfg, seed, ep=ep,
                                        phase="models", ccfg=MODELS_CCFG,
                                        trace=MODELS_TRACE,
                                        strategy=strategy, capture=cap)
        n = MEASURED[f"serve/{label}"]
        log("models", run=label, card=f"'{smi}'", strategy=strategy,
            step_p50_ms=f"{n['step_p50_ms']:.3f}",
            ttft_p50_ms=f"{n['ttft_p50_ms']:.3f}",
            decode_toks_per_s=f"{n['decode_toks_per_s']:.2f}",
            peak_gb=f"{n['peak_gb']:.3f}",
            measured_imbalance=(f"{n['measured_imbalance']:.4f}" if ep
                                else "n/a (dense path)"),
            modelled_imbalance=f"{n['modelled_imbalance']:.4f}",
            dropped_pairs=n["dropped_pairs"],
            launches=",".join(f"{k}:{launches.get(k, 0)}"
                              for k in SERVING_KERNELS),
            launches_exact=True)
        out[label] = launches
        del eng
        free_engines("models")
        if cap is not None:
            prefill_cases(cfg.name, cap, prefix="models",
                          max_slots=MODELS_CASE_SLOTS.get(arch, 0))
    del model
    free_engines("models")
    return out


def models_planner_times(seed: int) -> None:
    """Algorithm 1 at E 128 (switch-base-128's 12 layers, 4 ranks, one
    replica slot): the host planner ``duplicate_experts_host`` per layer
    (host ms) and the in-graph ``duplicate_experts_device`` over every
    layer at once (CUDA events), on Zipf-skewed histograms. Recorded, not
    tuned."""
    from repro_torch.core.duplication import (duplicate_experts_device,
                                              duplicate_experts_host)

    cfg = _model_cfg("switch-base-128", MODEL_LAYERS["switch-base-128"])
    E, L = cfg.moe.num_experts, cfg.num_layers
    rng = np.random.default_rng(seed)
    hist = np.stack([rng.permutation(1.0 / np.arange(1, E + 1) ** 1.2)
                     for _ in range(L)]) * 4096
    t0 = time.perf_counter()
    for l in range(L):
        duplicate_experts_host(hist[l] / hist[l].sum(), EP_RANKS, DUP_SLOTS,
                               cfg.moe.max_copies)
    host_ms = (time.perf_counter() - t0) * 1e3 / L
    counts = torch.tensor(hist, dtype=torch.float32, device="cuda")

    def device():
        return duplicate_experts_device(counts, EP_RANKS, DUP_SLOTS,
                                        cfg.moe.max_copies)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    log("models", planner="algorithm_1", experts=E, layers=L,
        ep_ranks=EP_RANKS, dup_slots=DUP_SLOTS,
        host_ms_per_layer=f"{host_ms:.4f}",
        device_ms_all_layers=f"{time_ms(device, flush, runs=10):.4f}")
    del flush


def models_train(arch: str, seed: int, ep: bool, smi: str,
                 layers: int = TRAIN_LAYERS, phase: str = "models",
                 flush=None, repeat: bool = False) -> dict:
    """``make_train_step`` on the model at published widths cut to
    ``layers`` layers (fp32 parameters, gradients and two moments),
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` Zipf tokens at
    the launcher's schedule (as the Mixtral runs), on the single-device MoE
    path or (``ep``) through the EP dispatch over 4 ranks under the
    identity plan with no replica slot (what ``launch.train --data-mesh 1
    --model-mesh 4`` runs). Per step loss, grad norm, drops (EP) and step
    ms; then step p50 (steps 1 on), tokens/s, peak memory and exact
    launches (one router forward and backward a layer and step, and under
    EP one ``histogram_offsets``, ``moe_gemm`` and ``moe_gemm_bwd``), and
    the model-FLOPs share of the card's peak. The loss must be finite and
    fall. With ``flush``, step ``CAPTURE_STEP``'s layer-0 inputs of the
    router's backward (and under EP ``moe_gemm_bwd``'s) are held against
    the plain versions (``_train_kernel_case``, case ``<phase>_train``);
    ``repeat``: then one batch repeated at a fixed lr from fresh moments,
    whose loss must fall (``_dense_repeat``). Returns the launches."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.core.placement import identity_plan, stack_plans, to_device
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_lr_fn
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.train.steps import init_opt_state, make_train_step

    cfg = _model_cfg(arch, layers)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, duplication_slots=0))
    L, mc = cfg.num_layers, cfg.moe
    rt = Runtime(ep=True, ep_ranks=EP_RANKS) if ep else Runtime()
    plan = (to_device(stack_plans([identity_plan(
        mc.num_experts, EP_RANKS, 0, mc.max_copies)] * L), mc.num_experts,
        EP_RANKS, 0, "cuda") if ep else None)
    run = f"{cfg.name}/{'ep' if ep else 'dense'}"
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda", trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    full = get_config(arch).num_layers
    log(phase, train=run, layers=L, params=n_params,
        state_gb=f"{16 * n_params / 1e9:.3f}", batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, base_lr=TRAIN_LR,
        reduced=f"'num_layers {full}->{L}: fp32 parameters, "
                f"gradients and two AdamW moments, 16 B a parameter'")
    opt = init_opt_state(model)
    step = make_train_step(cfg, rt, lr_fn=build_lr_fn(cfg, TRAIN_LR,
                                                      TRAIN_STEPS))
    gen = token_batches(seed, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    losses, step_ms, drops = [], [], []
    caps = []
    if flush is not None:
        caps.append(_BwdCapture("fused_topk_route_bwd", L))
        if ep:
            caps.append(_BwdCapture("moe_gemm_bwd", L))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with contextlib.ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        for i in range(TRAIN_STEPS):
            batch = next(gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt, m = step(model, opt, batch, plan)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            drops.append(int(m["dropped"].sum()) if ep else 0)
            log(phase, train=run, step=i, loss=f"{losses[-1]:.6f}",
                grad_norm=f"{float(m['grad_norm']):.6g}",
                lr=f"{float(m['lr']):.6g}", dropped_pairs=drops[-1],
                skew=f"{_skew(m['expert_counts']):.4f}",
                step_ms=f"{step_ms[-1]:.3f}")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels = TRAIN_EP_KERNELS if ep else ("fused_topk_route",
                                           "fused_topk_route_bwd")
    want = {k: 0 for k in launches}
    want.update({k: L * TRAIN_STEPS for k in kernels})
    p50 = float(np.median(step_ms[1:]))
    pairs = TRAIN_BATCH * TRAIN_SEQ * mc.top_k * L
    mflops = model_flops(cfg, InputShape("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    log(phase, train=run, card=f"'{smi}'",
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
        step_ms_p50=f"{p50:.3f}", step_ms_first=f"{step_ms[0]:.3f}",
        tokens_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}",
        model_flops_per_step=f"{mflops:.6g}",
        model_flops_share_of_peak=f"{mflops / (p50 / 1e3 * PEAK_FLOPS):.6g}",
        dropped_share=f"{np.mean(drops) / pairs:.4f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        launches_exact=launches == want)
    failures = []
    if launches != want:
        failures.append(f"launches {launches} != {want}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        failures.append(f"loss {losses[0]} -> {losses[-1]}")
    del opt, m
    for c in caps:
        _train_kernel_case(c.name, c, flush, case=f"{phase}_train")
    del caps
    if repeat:
        gc.collect()
        torch.cuda.empty_cache()
        batch = next(token_batches(seed + 1, cfg.vocab_size, TRAIN_BATCH,
                                   TRAIN_SEQ))
        rl = _dense_repeat(cfg, model, batch, remat=False)
        log(phase, train=run, repeat_batch_losses=",".join(
            f"{v:.6f}" for v in rl), lr=TRAIN_REPEAT_LR, falls=rl[-1] < rl[0])
        if not rl[-1] < rl[0]:
            failures.append(f"the repeated batch's loss did not fall: {rl}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"{phase} (train {run}) failed: "
                         + "; ".join(failures))
    return launches


def models_phase(seed: int, smi: str) -> dict:
    """Phase models: serving for each of ``MODEL_LAYERS`` (``models_serve``),
    Algorithm 1's times at E 128, then training for ``MODELS_TRAIN``, dense
    and EP (``models_train``). Frees what earlier phases hold first.
    Returns every run's launches, by run."""
    free_engines("models")
    t0 = time.perf_counter()
    out = {}
    for arch in MODEL_LAYERS:
        t1 = time.perf_counter()
        out.update(models_serve(arch, seed, smi))
        log("models", model=arch, serve_s=f"{time.perf_counter() - t1:.3f}")
    models_planner_times(seed)
    for arch in MODELS_TRAIN:
        for ep in (False, True):
            t1 = time.perf_counter()
            out[f"{arch}/train_{'ep' if ep else 'dense'}"] = models_train(
                arch, seed, ep, smi)
            log("models", model=arch, train_ep=ep,
                train_s=f"{time.perf_counter() - t1:.3f}")
    log("models", train="arctic-480b", card_run="none",
        reason="'one full-width layer holds 13.61e9 parameters: 16 B each "
               "of fp32 parameters, gradients and two AdamW moments is 218 "
               "GB, beyond one 80 GB card; arctic's train step is held "
               "against the JAX package on the CPU at reduced() "
               "(tests/test_torch_moe_models_train.py)'")
    log("models", phase_s=f"{time.perf_counter() - t0:.3f}")
    return out


# ---------------------------------------------------------------------------
# phase dense: the dense family at published widths
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("qwen1.5-0.5b", "olmo-1b", "stablelm-3b", "minicpm-2b")
# launch.serve's ServeEngine run: one batch of 8 x 512, 64 new tokens each
DENSE_LAUNCH_SERVE = ("qwen1.5-0.5b", "minicpm-2b")
DENSE_SERVE_ARGS = dict(requests=8, batch=8, seq=512, new_tokens=64)
# fp32 state (weights, gradients, two moments: 16 B a parameter) of 44.7 and
# 43.6 GB: with 4 x 512 tokens' activations of every layer held for the
# backward the step would not stay inside 80 GB, so each layer is recomputed
DENSE_REMAT = ("stablelm-3b", "minicpm-2b")
DENSE_PROFILE_ITERS = 6
# minicpm-2b trains through the launcher, so its WSD schedule runs here
DENSE_LAUNCH_TRAIN = "minicpm-2b"


def _launch(module, argv, phase: str, trace: str):
    """``module.main(argv)`` with its stdout logged line by line; returns
    (return code, stdout, the trace's complete spans by name)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    torch.cuda.synchronize()
    for line in out.getvalue().splitlines():
        log(phase, stdout=f"'{line}'")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return rc, out.getvalue(), spans


def dense_serve(arch: str, seed: int, smi: str) -> list:
    """One dense model at published widths, every layer, random bf16
    weights from ``seed`` (qwen's QKV biases drawn nonzero, N(0, 0.5)):
    ``ContinuousEngine`` on phase 4's trace (``serve_trace``: completions,
    tokens, exact launches, paged attention once a layer a decode step),
    then ``profile_phase``'s decode steps (the device's idle share); for
    ``DENSE_LAUNCH_SERVE`` then ``repro_torch.launch.serve.main`` (a fresh
    model from the same seed through ``ServeEngine``). Returns failures."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import init_model

    cfg = get_config(arch)
    log("dense", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        qkv_bias=cfg.qkv_bias, norm=cfg.norm,
        tie_embeddings=cfg.tie_embeddings, lr_schedule=cfg.lr_schedule,
        params=cfg.num_params(), reduced="'none: published widths, all "
        f"{cfg.num_layers} layers'")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    if cfg.qkv_bias:
        gen = torch.Generator(device="cuda").manual_seed(seed + 7)
        with torch.no_grad():
            for layer in model.layers:
                for n in ("bq", "bk", "bv"):
                    b = getattr(layer, n)
                    b.copy_(torch.randn(b.shape, generator=gen, device="cuda")
                            * 0.5)
    torch.cuda.synchronize()
    log("dense", model=cfg.name, init_s=f"{time.perf_counter() - t0:.3f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    label = f"dense/{cfg.name}"
    eng, launches = serve_trace(label, model, cfg, seed, ep=False,
                                phase="dense", strategy="none")
    n = MEASURED[f"serve/{label}"]
    log("dense", run=label, card=f"'{smi}'",
        step_p50_ms=f"{n['step_p50_ms']:.3f}",
        ttft_p50_ms=f"{n['ttft_p50_ms']:.3f}",
        decode_toks_per_s=f"{n['decode_toks_per_s']:.2f}",
        peak_gb=f"{n['peak_gb']:.3f}", decode_steps=eng.decode_steps,
        paged_decode_attention_calls=launches["paged_decode_attention"],
        device_launches=2 * launches["paged_decode_attention"],
        expected_calls=f"{eng.decode_steps}x{cfg.num_layers}",
        launches_exact=True)
    profile_phase(eng, cfg, seed, label, iters=DENSE_PROFILE_ITERS)
    del eng
    del model
    free_engines("dense")
    failures = []
    if arch in DENSE_LAUNCH_SERVE:
        a = DENSE_SERVE_ARGS
        trace = os.path.join(ROOT, "build", "chip_smoke",
                             f"dense_serve_{arch}.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        argv = ["--arch", arch, "--requests", str(a["requests"]),
                "--batch", str(a["batch"]), "--seq", str(a["seq"]),
                "--new-tokens", str(a["new_tokens"]), "--seed", str(seed),
                "--device", "cuda", "--trace-out", trace]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        rc, out, spans = _launch(launch_serve, argv, "dense", trace)
        launches = dict(ops.LAUNCHES)
        decode = spans.get("decode", [])
        log("dense", run=f"launch.serve/{arch}", card=f"'{smi}'",
            argv=f"'{' '.join(argv)}'", rc=rc,
            prefill_ms=",".join(f"{v:.3f}" for v in spans.get("prefill", [])),
            decode_steps=len(decode),
            decode_ms_p50=f"{np.median(decode):.3f}" if decode else "n/a",
            decode_toks_per_s=(f"{a['batch'] / np.median(decode) * 1e3:.2f}"
                               if decode else "n/a"),
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
            launches=",".join(f"{k}:{v}" for k, v in launches.items()))
        if rc != 0 or f"served {a['requests']} requests" not in out:
            failures.append(f"launch.serve {arch}: exit {rc}")
        if any(launches.values()):
            # the linear cache decodes without the paged kernel
            failures.append(f"launch.serve {arch}: launches {launches}")
        if len(decode) != a["new_tokens"] - 1:
            failures.append(f"launch.serve {arch}: {len(decode)} decode steps")
        gc.collect()
        torch.cuda.empty_cache()
    return failures


def _dense_repeat(cfg, model, batch, remat: bool,
                  lr: float = TRAIN_REPEAT_LR) -> list:
    """``TRAIN_REPEAT_STEPS + 1`` steps on one batch at a fixed ``lr`` from
    fresh moments: the losses."""
    from repro_torch.models.transformer import Runtime
    from repro_torch.train.steps import init_opt_state, make_train_step

    opt = init_opt_state(model)
    rep = make_train_step(cfg, Runtime(), lr_fn=lambda s: lr, remat=remat)
    losses = []
    for _ in range(TRAIN_REPEAT_STEPS + 1):
        opt, m = rep(model, opt, batch)
        losses.append(float(m["loss"]))
    del opt
    return losses


def dense_train(arch: str, seed: int, smi: str) -> list:
    """``TRAIN_STEPS`` train steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` Zipf
    tokens (``token_batches(seed)``) at the launcher's schedule, every layer
    at published widths, fp32 weights from ``seed``, each layer recomputed
    for ``DENSE_REMAT``: minicpm-2b through ``repro_torch.launch.train.main``
    (its WSD schedule, step times from its trace), the others through
    ``make_train_step``. Per step loss, lr, grad norm and ms; then step p50,
    tokens/s, peak memory, the model-FLOPs share of peak; the loss must fall
    (the launcher's exit 0), nothing may launch a kernel (the dense path has
    none in training), and one batch repeated at a fixed lr from fresh
    moments must lose loss. Then ``train_breakdown`` at those weights.
    Returns failures."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.train import build_lr_fn
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.train.steps import init_opt_state, make_train_step

    cfg = get_config(arch)
    remat = arch in DENSE_REMAT
    run = f"dense/{cfg.name}"
    n_params = cfg.num_params()
    log("dense", train=run, layers=cfg.num_layers, params=n_params,
        state_gb=f"{16 * n_params / 1e9:.3f}", batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, base_lr=TRAIN_LR,
        schedule=cfg.lr_schedule, remat=remat,
        reduced="'none: published widths, all layers'")
    failures, lrs, losses = [], [], []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    if arch == DENSE_LAUNCH_TRAIN:
        trace = os.path.join(ROOT, "build", "chip_smoke",
                             f"dense_train_{arch}.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        argv = ["--arch", arch, "--steps", str(TRAIN_STEPS),
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--lr", str(TRAIN_LR), "--log-every", "1",
                "--seed", str(seed), "--device", "cuda",
                "--trace-out", trace] + (["--remat"] if remat else [])
        log("dense", train=run, argv=f"'{' '.join(argv)}'")
        rc, out, spans = _launch(launch_train, argv, "dense", trace)
        step_ms = spans.get("train_step", [])
        for line in out.splitlines():
            if line.startswith("step "):
                losses.append(float(line.split("loss=")[1].split()[0]))
                lrs.append(float(line.split("lr=")[1].split()[0]))
        want_lr = [float(build_lr_fn(cfg, TRAIN_LR, TRAIN_STEPS)(s))
                   for s in range(TRAIN_STEPS)]
        log("dense", train=run, rc=rc, lr_per_step=",".join(
            f"{v:.3g}" for v in lrs), wsd_lr_per_step=",".join(
            f"{v:.3g}" for v in want_lr))
        if rc != 0:
            failures.append(f"launch.train {arch}: exit {rc}")
        if len(step_ms) != TRAIN_STEPS or [f"{v:.2e}" for v in lrs] != \
                [f"{v:.2e}" for v in want_lr]:
            failures.append(f"launch.train {arch}: {len(step_ms)} steps, lr "
                            f"{lrs} != {want_lr}")
        gc.collect()
        torch.cuda.empty_cache()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model = init_model(cfg, torch.Generator(device="cuda").manual_seed(
            seed), device="cuda", trainable=True)
    else:
        model = init_model(cfg, torch.Generator(device="cuda").manual_seed(
            seed), device="cuda", trainable=True)
        opt = init_opt_state(model)
        step = make_train_step(cfg, Runtime(), lr_fn=build_lr_fn(
            cfg, TRAIN_LR, TRAIN_STEPS), remat=remat)
        gen = token_batches(seed, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
        step_ms = []
        for i in range(TRAIN_STEPS):
            batch = next(gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt, m = step(model, opt, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
            log("dense", train=run, step=i, loss=f"{losses[-1]:.6f}",
                nll=f"{float(m['nll']):.6f}",
                grad_norm=f"{float(m['grad_norm']):.6g}",
                lr=f"{lrs[-1]:.6g}", step_ms=f"{step_ms[-1]:.3f}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del opt, m
        if not losses[-1] < losses[0]:
            failures.append(f"loss {losses[0]} -> {losses[-1]}")
    launches = dict(ops.LAUNCHES)
    p50 = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mflops = model_flops(cfg, InputShape("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    log("dense", train=run, card=f"'{smi}'", steps=len(step_ms),
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
        step_ms=",".join(f"{v:.3f}" for v in step_ms),
        step_ms_p50=f"{p50:.3f}", tokens_per_s=f"{tokens / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}", model_flops_per_step=f"{mflops:.6g}",
        model_flops_share_of_peak=f"{mflops / (p50 / 1e3 * PEAK_FLOPS):.6g}",
        note="6 x params x tokens (remat adds a forward the yardstick does "
             "not count)" if remat else "6 x params x tokens",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    if any(launches.values()):
        failures.append(f"train launches {launches}")
    if not all(np.isfinite(losses)):
        failures.append(f"loss not finite: {losses}")
    # one batch again and again at a fixed lr, from fresh moments
    gc.collect()
    torch.cuda.empty_cache()
    batch = next(token_batches(seed + 1, cfg.vocab_size, TRAIN_BATCH,
                               TRAIN_SEQ))
    rl = _dense_repeat(cfg, model, batch, remat)
    log("dense", train=run, repeat_batch_losses=",".join(
        f"{v:.6f}" for v in rl), lr=TRAIN_REPEAT_LR, falls=rl[-1] < rl[0])
    if not rl[-1] < rl[0]:
        failures.append(f"the repeated batch's loss did not fall: {rl}")
    opt = init_opt_state(model)
    train_breakdown(run, cfg, model, opt, batch, remat=remat)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def dense_card_vs_cpu(seed: int) -> None:
    """Each reduced dense config (stablelm's also at head_dim 80; qwen's QKV
    biases drawn nonzero) on the card (the paged kernel) against the same
    bridged weights on the CPU (plain versions): a slot prefill and one
    paged decode step, logits within 5e-2 x max|logit| (bf16 activations,
    sums in other orders), one paged attention launch a layer on the card
    and none on the CPU."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Runtime, init_model

    failures = []
    for arch, hd in [(a, 0) for a in DENSE_ARCHS] + [("stablelm-3b", 80)]:
        cfg = get_config(arch).reduced()
        if hd:
            cfg = dataclasses.replace(cfg, head_dim=hd)
        gpu = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
        if cfg.qkv_bias:
            with torch.no_grad():
                for layer in gpu.layers:
                    for n in ("bq", "bk", "bv"):
                        getattr(layer, n).normal_(0.0, 0.5)
        cpu = params_from_jax(params_to_jax(gpu), cfg, device="cpu")
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
        forced = rng.integers(0, cfg.vocab_size, 1).astype(np.int32)
        rt = Runtime(window_override=64)
        logits, launches = {}, {}
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            ops.reset_launches()
            logits[name], _ = _reference_run(model, cfg, rt, None, prompt,
                                             forced, 32, 8)
            launches[name] = dict(ops.LAUNCHES)
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        scale = float(logits["cpu"].abs().max())
        want = {k: 0 for k in launches["cuda"]}
        want["paged_decode_attention"] = cfg.num_layers
        ok = (bool(torch.isfinite(logits["cuda"]).all())
              and err <= 5e-2 * max(scale, 1.0)
              and launches["cuda"] == want
              and not any(launches["cpu"].values()))
        log("dense", card_vs_cpu=cfg.name, head_dim=cfg.head_dim,
            steps="prefill+1decode", max_abs_err=f"{err:.6g}",
            logit_scale=f"{scale:.6g}",
            tolerance="5e-2 x max|logit| (bf16 activations, CPU vs GPU sums)",
            kernel_launches=",".join(f"{k}:{v}" for k, v in
                                     launches["cuda"].items()), ok=ok)
        if not ok:
            failures.append(f"{cfg.name} hd {cfg.head_dim}")
    if failures:
        raise SystemExit(f"reduced dense model on the card disagrees with the "
                         f"CPU path: {failures}")


def dense_phase(seed: int, smi: str) -> None:
    """Phase dense: for each of ``DENSE_ARCHS`` at published widths and all
    layers, serving (``dense_serve``) then training (``dense_train``);
    then the reduced models card against CPU. Frees what earlier phases
    hold first."""
    free_engines("dense")
    t0 = time.perf_counter()
    failures = []
    for arch in DENSE_ARCHS:
        t1 = time.perf_counter()
        failures += dense_serve(arch, seed, smi)
        t2 = time.perf_counter()
        failures += dense_train(arch, seed, smi)
        log("dense", model=arch, serve_s=f"{t2 - t1:.3f}",
            train_s=f"{time.perf_counter() - t2:.3f}")
    dense_card_vs_cpu(seed)
    log("dense", phase_s=f"{time.perf_counter() - t0:.3f}")
    if failures:
        raise SystemExit("dense failed: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# phase mla: deepseek-v2-lite-16b (MLA attention, shared experts)
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-lite-16b"
MLA_SERVE = dict(requests=8, batch=8, seq=512, new_tokens=64)
# (leg, ep, strategy): the dense MoE path, then EP (4 ranks, one replica
# slot, the store) under dist_only and under none
MLA_LEGS = (("dense", False, "dist_only"), ("ep", True, "dist_only"),
            ("ep_none", True, "none"))
MLA_PROFILE_STEPS = 2
# 4 of 27 layers: 2.759e9 parameters, 44.1 GB of fp32 state; 2 layers
# (25.4 GB) if 4 runs out of device memory
MLA_TRAIN_LAYERS = (4, 2)
MLA_SERVE_CUT = ("none: published widths, all 27 layers (16.21e9 "
                 "parameters, 32.4 GB bf16)")


def mla_variants(cfg):
    """The reduced config and its two variants (``tests/test_torch_mla_
    models.py``'s): q/k 96 wide with head_dim 64 and V narrower than nope,
    and the published routing's K 6 over 16 experts with 2 shared."""
    return {"reduced": cfg,
            "scale": dataclasses.replace(cfg, mla=dataclasses.replace(
                cfg.mla, nope_head_dim=64, rope_head_dim=32, v_head_dim=48)),
            "router": dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=16, top_k=6, num_shared_experts=2))}


def mla_serve_leg(label: str, model, cfg, tokens, ep: bool, strategy: str,
                  smi: str, cap=None):
    """One ``ServeEngine`` run of deepseek: one batch of ``MLA_SERVE``
    through ``generate``, every kernel count set to 0 just before and read
    just after; the prefill and each decode step timed on the host clock
    between synchronisations. Prints prefill ms, decode step p50, decode
    tokens/s, peak memory, the measured (the prefill's slot counts, EP)
    and modelled (the prefill's expert counts under the identity plan and
    under the plan in force after the batch) rank imbalance, dropped
    pairs, and the launches against ``expected_launches`` (no paged
    attention: the latent cache is linear). With ``cap`` the prefill's
    layer-0 kernel inputs are kept. Returns (engine, failures)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.metrics import imbalance, plan_rank_loads

    a = MLA_SERVE
    eng = ServeEngine(cfg, model, ServeConfig(
        strategy=strategy, predict_interval=1, dup_slots=DUP_SLOTS,
        max_len=a["seq"] + a["new_tokens"]), ep_ranks=EP_RANKS, ep=ep)
    rec = {"prefill_ms": [], "decode_ms": [], "stats": None}
    dec_dropped = torch.zeros((), dtype=torch.float64, device="cuda")
    step_prefill, step_decode = eng._prefill, eng._decode

    def prefill_step(*args, **kw):
        if cap is not None:
            cap.armed = True
        out = step_prefill(*args, **kw)
        if cap is not None:
            cap.armed = False
        rec["stats"] = out[2]
        return out

    def decode_step(*args, **kw):
        nonlocal dec_dropped
        out = step_decode(*args, **kw)
        if ep:
            dec_dropped = dec_dropped + out[3]["dropped"].sum()
        return out
    eng._prefill, eng._decode = prefill_step, decode_step
    prefill, decode = eng.prefill, eng.decode

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    eng.prefill, eng.decode = timed(prefill, "prefill_ms"), \
        timed(decode, "decode_ms")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, _ = eng.generate({"tokens": tokens}, max_new_tokens=a["new_tokens"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eng.prefill, eng.decode = prefill, decode
    eng._prefill, eng._decode = step_prefill, step_decode
    toks = out.cpu().numpy()
    st = rec["stats"]
    counts = st["expert_counts"].cpu().numpy()
    m = eng.moe_cfg
    modelled_id = imbalance(plan_rank_loads(counts, None, EP_RANKS,
                                            m.duplication_slots))
    plan = eng._plan_stack
    modelled = (imbalance(plan_rank_loads(counts, plan, EP_RANKS,
                                          m.duplication_slots))
                if plan is not None else modelled_id)
    measured = (imbalance(eng.rank_loads(st["slot_counts"].cpu().numpy()))
                if ep else None)
    pre_dropped = int(st["dropped"].sum()) if ep else 0
    dropped = pre_dropped + int(dec_dropped)
    want = expected_launches(launches, cfg, 1, a["new_tokens"] - 1, ep=ep,
                             paged=False)
    dec = rec["decode_ms"]
    p50 = float(np.median(dec))
    log("mla", run=label, card=f"'{smi}'", strategy=strategy,
        store=eng._store is not None, batch=a["batch"], seq=a["seq"],
        new_tokens=a["new_tokens"],
        prefill_ms=f"{rec['prefill_ms'][0]:.3f}",
        decode_steps=len(dec), decode_step_p50_ms=f"{p50:.3f}",
        decode_toks_per_s=f"{a['batch'] / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}",
        measured_imbalance=(f"{measured:.4f}" if ep
                            else "n/a (dense path)"),
        modelled_imbalance=f"{modelled:.4f}",
        modelled_imbalance_identity=f"{modelled_id:.4f}",
        window_skew=f"{eng.history[-1]['skew']:.4f}",
        dropped_pairs=dropped, prefill_dropped_pairs=pre_dropped,
        decode_dropped_pairs=int(dec_dropped),
        migration_entries=eng.history[-1].get("migration_entries", "-"),
        launches=",".join(f"{k}:{launches.get(k, 0)}"
                          for k in SERVING_KERNELS),
        launches_expected=",".join(f"{k}:{want.get(k, 0)}"
                                   for k in SERVING_KERNELS),
        launches_exact=launches == want)
    failures = []
    if launches != want:
        failures.append(f"{label}: launches {launches} != {want}")
    if toks.shape != (a["batch"], a["new_tokens"]) or (toks < 0).any() \
            or (toks >= cfg.vocab_size).any():
        failures.append(f"{label}: bad tokens of shape {toks.shape}")
    if len(dec) != a["new_tokens"] - 1:
        failures.append(f"{label}: {len(dec)} decode steps")
    return eng, failures


def mla_decode_profile(eng, cfg, tokens, label: str) -> None:
    """The device's idle share of a decode step: a fresh prefill of
    ``tokens``, two decode steps, then ``MLA_PROFILE_STEPS`` more under
    torch.profiler (host wall per step, device busy time by kernel)."""
    logits, cache, _ = eng.prefill({"tokens": tokens})
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = tokens.shape[1]
    for _ in range(2):
        tok, _, cache, _ = eng.decode(tok, cache, pos)
        pos += 1
    torch.cuda.synchronize()

    def steps():
        nonlocal tok, cache, pos
        t0 = time.perf_counter()
        for _ in range(MLA_PROFILE_STEPS):
            tok, _, cache, _ = eng.decode(tok, cache, pos)
            pos += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / MLA_PROFILE_STEPS

    prof, wall_ms = profiled(steps, f"the {label} decode step", cpu=True)
    kernels = {} if prof is None else _kernel_time_by_name(
        prof, MLA_PROFILE_STEPS)
    busy = sum(ms for ms, _ in kernels.values()) if kernels else NOT_MEASURED
    log("mla", profile=label, decode_steps=MLA_PROFILE_STEPS,
        cache_len=pos, profiled_step_ms=f"{wall_ms:.3f}",
        device_busy_ms_per_step=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall_ms:.4f}",
        device_ops_per_step=f"{sum(n for _, n in kernels.values()) / MLA_PROFILE_STEPS:.1f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        log("mla", profile=label, ms_per_step=f"{ms:.4f}",
            share=f"{ms / busy:.4f}", per_step=f"{n / MLA_PROFILE_STEPS:.1f}",
            kernel=f"'{name[:90]}'")
    del cache, logits


def mla_serve(seed: int, smi: str) -> list:
    """deepseek-v2-lite-16b at published widths, all 27 layers, random
    bf16 weights from ``seed``, through ``ServeEngine`` in each of
    ``MLA_LEGS`` (``mla_serve_leg``) on one batch of Zipf prompts
    (``token_batches(seed)``); the EP dist_only run's prefill's layer-0
    router, histogram and moe_gemm inputs held against their plain
    versions (the kernels line's ``mla_<model>`` case) and one of its
    decode steps profiled. Returns failures."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models.transformer import init_model

    cfg = get_config(MLA_ARCH)
    m, a = cfg.moe, MLA_SERVE
    log("mla", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_lora_rank=cfg.mla.kv_lora_rank,
        rope_head_dim=cfg.mla.rope_head_dim,
        nope_head_dim=cfg.mla.nope_head_dim,
        v_head_dim=cfg.mla.v_head_dim,
        softmax_scale=f"1/sqrt({cfg.mla.nope_head_dim + cfg.mla.rope_head_dim})",
        experts=m.num_experts, top_k=m.top_k, shared_experts=m.num_shared_experts,
        d_ff_expert=m.d_ff_expert, vocab=cfg.vocab_size,
        capacity_factor=m.capacity_factor, ep_ranks=EP_RANKS,
        dup_slots=DUP_SLOTS, params=cfg.num_params(),
        latent_cache_bytes_per_token=2 * cfg.num_layers
        * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim),
        reduced=f"'{MLA_SERVE_CUT}'")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    log("mla", model=cfg.name, init_s=f"{time.perf_counter() - t0:.3f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    tokens = next(token_batches(seed, cfg.vocab_size, a["batch"],
                                a["seq"]))["tokens"]
    failures = []
    for leg, ep, strategy in MLA_LEGS:
        t1 = time.perf_counter()
        cap = _PrefillCapture() if (ep and strategy == "dist_only") else None
        with cap or contextlib.nullcontext():
            eng, fails = mla_serve_leg(f"{cfg.name}/{leg}", model, cfg,
                                       tokens, ep, strategy, smi, cap)
        failures += fails
        if cap is not None:
            # (the kept moe_gemm inputs name the store's rows)
            prefill_cases(cfg.name, cap, prefix="mla")
            mla_decode_profile(eng, cfg, tokens, f"{cfg.name}/{leg}")
        del eng, cap
        free_engines("mla")
        log("mla", run=f"{cfg.name}/{leg}",
            leg_s=f"{time.perf_counter() - t1:.3f}")
    del model
    free_engines("mla")
    return failures


def mla_launch_serve(seed: int, smi: str) -> list:
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --data-mesh 1 --model-mesh 4`` (``main`` in this process, a fresh
    model from ``seed``): one batch of ``MLA_SERVE``, exit 0, every request
    served, exact launches. Returns failures."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    a = MLA_SERVE
    cfg = get_config(MLA_ARCH)
    trace = os.path.join(ROOT, "build", "chip_smoke", "mla_launch_serve.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    argv = ["--arch", MLA_ARCH, "--requests", str(a["requests"]),
            "--batch", str(a["batch"]), "--seq", str(a["seq"]),
            "--new-tokens", str(a["new_tokens"]), "--data-mesh", "1",
            "--model-mesh", str(EP_RANKS), "--seed", str(seed),
            "--device", "cuda", "--trace-out", trace]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rc, out, spans = _launch(launch_serve, argv, "mla", trace)
    launches = dict(ops.LAUNCHES)
    decode = spans.get("decode", [])
    batches = a["requests"] // a["batch"]
    want = expected_launches(launches, cfg, batches,
                             batches * (a["new_tokens"] - 1), ep=True,
                             paged=False)
    log("mla", run=f"launch.serve/{MLA_ARCH}", card=f"'{smi}'",
        argv=f"'{' '.join(argv)}'", rc=rc,
        prefill_ms=",".join(f"{v:.3f}" for v in spans.get("prefill", [])),
        decode_steps=len(decode),
        decode_ms_p50=f"{np.median(decode):.3f}" if decode else "n/a",
        decode_toks_per_s=(f"{a['batch'] / np.median(decode) * 1e3:.2f}"
                           if decode else "n/a"),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        launches_exact=launches == want)
    failures = []
    if rc != 0 or f"served {a['requests']} requests" not in out:
        failures.append(f"launch.serve {MLA_ARCH}: exit {rc}")
    if launches != want:
        failures.append(f"launch.serve {MLA_ARCH}: launches {launches} != "
                        f"{want}")
    if len(decode) != batches * (a["new_tokens"] - 1):
        failures.append(f"launch.serve {MLA_ARCH}: {len(decode)} decode "
                        "steps")
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def mla_train(seed: int, smi: str, flush) -> dict:
    """``models_train`` on deepseek at published widths cut to the first
    of ``MLA_TRAIN_LAYERS`` that fits the card: dense (then one batch
    repeated at a fixed lr, whose loss must fall) and EP over 4 ranks,
    each with step ``CAPTURE_STEP``'s layer-0 backward inputs held against
    the plain versions (case ``mla_train``). Returns the launches, by
    run."""
    out = {}
    for ep in (False, True):
        for layers in MLA_TRAIN_LAYERS:
            t1 = time.perf_counter()
            try:
                out[f"train_{'ep' if ep else 'dense'}"] = models_train(
                    MLA_ARCH, seed, ep, smi, layers=layers, phase="mla",
                    flush=flush, repeat=not ep)
            except torch.cuda.OutOfMemoryError as e:
                log("mla", train_ep=ep, layers=layers, out_of_memory=True,
                    error=f"'{str(e).splitlines()[0][:160]}'")
                gc.collect()
                torch.cuda.empty_cache()
                continue
            log("mla", train_ep=ep, layers=layers,
                train_s=f"{time.perf_counter() - t1:.3f}")
            break
        else:
            raise SystemExit(f"mla: training ep={ep} ran out of memory at "
                             f"every depth of {MLA_TRAIN_LAYERS}")
    return out


def _mla_reference_run(model, cfg, rt, tokens, forced):
    """A prefill of ``tokens`` (B, S) into a fresh latent cache and one
    teacher-forced decode step (``ServeEngine``'s steps). Returns (logits
    (2, B, V) fp32 on the host, the latent cache on the host, the two
    stats moved to the host)."""
    from repro_torch.models.transformer import forward, init_cache

    dev = model.device
    B, S = tokens.shape
    cache = init_cache(cfg, rt, B, S + 1, device=dev)
    with torch.inference_mode():
        lg, cache, st = forward(model, cfg, torch.tensor(tokens, device=dev),
                                rt, mode="prefill", cache=cache)
        lg2, cache, st2 = forward(model, cfg, torch.tensor(forced, device=dev),
                                  rt, mode="decode", cache=cache,
                                  cache_len=S)
    host = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in s.items()}
            for s in (st, st2)]
    return (torch.stack([lg[:, -1].float().cpu(), lg2[:, -1].float().cpu()]),
            {k: v.float().cpu() for k, v in cache.items()}, host)


def mla_card_vs_cpu(seed: int) -> None:
    """The reduced deepseek and its two variants (``mla_variants``) on the
    card against the same bridged weights on the CPU: a prefill of 2 x 32
    tokens and one decode step over the latent cache, on the dense path
    and on the EP path (4 ranks, the identity plan). Logits and the latent
    cache within 5e-2 x their largest magnitude (bf16 activations, sums in
    other orders); router weights scaled by 25 so that routing margins
    stand clear of the bf16 noise between the devices, and where the CPU
    run still holds near-tie decisions each may move at most two pairs of
    the EP slot counts; the kernels launch on the card only."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Runtime, init_model

    failures = []
    rng = np.random.default_rng(seed)
    for name, cfg in mla_variants(get_config(MLA_ARCH).reduced()).items():
        gpu = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
        with torch.no_grad():
            for layer in gpu.layers:
                layer.router.mul_(25.0)
        cpu = params_from_jax(params_to_jax(gpu), cfg, device="cpu")
        tokens = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        forced = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        for path, rt in (("dense", Runtime()),
                         ("ep", Runtime(ep=True, ep_ranks=EP_RANKS))):
            res, launches, near = {}, {}, 0
            for dev, model in (("cuda", gpu), ("cpu", cpu)):
                ops.reset_launches()
                res[dev], n = _near_tie_routes(
                    lambda: _mla_reference_run(model, cfg, rt, tokens, forced))
                launches[dev] = dict(ops.LAUNCHES)
                near = n if dev == "cpu" else near
            (lg_c, cache_c, st_c), (lg_h, cache_h, st_h) = res["cuda"], res["cpu"]
            err = float((lg_c - lg_h).abs().max())
            scale = float(lg_h.abs().max())
            cache_err = max(float((cache_c[k] - cache_h[k]).abs().max())
                            / max(float(cache_h[k].abs().max()), 1e-6)
                            for k in cache_h)
            L = cfg.num_layers
            want = {k: 0 for k in launches["cuda"]}
            want["fused_topk_route"] = 2 * L
            for k in EP_KERNELS:
                want[k] = 2 * L if path == "ep" else 0
            key = "slot_counts" if path == "ep" else "expert_counts"
            moved = sum(int((a[key].to(torch.int64) - b[key].to(torch.int64))
                            .abs().sum()) for a, b in zip(st_c, st_h))
            ok = (bool(torch.isfinite(lg_c).all())
                  and err <= 5e-2 * max(scale, 1.0) and cache_err <= 5e-2
                  and launches["cuda"] == want
                  and not any(launches["cpu"].values())
                  and moved <= 2 * near)
            log("mla", card_vs_cpu=f"{cfg.name}/{name}", path=path,
                steps="prefill+1decode", max_abs_err=f"{err:.6g}",
                logit_scale=f"{scale:.6g}",
                cache_rel_err=f"{cache_err:.6g}",
                tolerance="5e-2 x max|logit|, 5e-2 of the cache's largest "
                          "(bf16 activations, CPU vs GPU sums)",
                near_tie_routes_cpu=near, count_pairs_moved=moved,
                kernel_launches=",".join(f"{k}:{v}" for k, v in
                                         launches["cuda"].items()), ok=ok)
            if not ok:
                failures.append(f"{name}/{path}")
        del gpu, cpu
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"reduced deepseek on the card disagrees with the "
                         f"CPU path: {failures}")


def mla_phase(seed: int, smi: str) -> dict:
    """Phase mla: deepseek-v2-lite-16b served through ``ServeEngine`` at
    all 27 layers (dense, EP dist_only, EP none), through
    ``launch.serve`` with 4 EP ranks, trained at 4 of 27 layers dense and
    EP, and its reduced config and variants card against CPU. Frees what
    earlier phases hold first. Returns the training runs' launches."""
    free_engines("mla")
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    failures = mla_serve(seed, smi)
    t2 = time.perf_counter()
    failures += mla_launch_serve(seed, smi)
    t3 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = mla_train(seed, smi, flush)
    del flush
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    mla_card_vs_cpu(seed)
    log("mla", serve_s=f"{t2 - t1:.3f}", launch_serve_s=f"{t3 - t2:.3f}",
        train_s=f"{t4 - t3:.3f}",
        card_vs_cpu_s=f"{time.perf_counter() - t4:.3f}",
        phase_s=f"{time.perf_counter() - t0:.3f}")
    if failures:
        raise SystemExit("mla failed: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# phase rwkv: rwkv6-7b (the attention-free RWKV-6 time mix and channel mix)
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-7b"
RWKV_SERVE = dict(batch=8, seq=512, new_tokens=64)
RWKV_LAUNCH = dict(requests=8, batch=8, seq=512, new_tokens=16)
RWKV_PROFILE_STEPS = 2
# fp32 state (16 B a parameter) of 8 layers: 36.9 GB; the first depth that
# fits is taken
RWKV_TRAIN_LAYERS = (8, 6, 4)
RWKV_VARIANTS = ("init", "clip", "shift")
# one full-width layer's WKV: (B, S, H, hd)
RWKV_CHUNK_CASE = (8, 512, 64, 64)
WKV_REL = 1e-4                     # wkv_chunked against the wkv_step loop
# the card's WKV state against the CPU's, in norm: layer 0's (its inputs
# are the same embedding rows: only its bf16 projections round apart), and
# every layer's (later layers integrate bf16 hidden states an ulp apart:
# the CPU tests' tolerance for the state against JAX)
RWKV_STATE_REL = 1e-3
RWKV_STATE_REL_ALL = 1e-2
WKV_RANGE = "chip_smoke.wkv"       # the profiler range around wkv_chunked


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over every element, in fp64 on the host."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def rwkv_variant(model, name: str, seed: int) -> None:
    """The weight variants that show what the JAX init hides (the CPU
    tests' own, ``tests/test_torch_rwkv_models.py``): "clip" sets every
    layer's ``decay_base`` to +1.0, so every decay rate clips to
    ``MAX_RATE`` and the chunk's rescaling reaches exp(0.9 x 32); "shift"
    redraws the time and channel mixes' ``mu`` at scale 0.5 (a standard
    normal truncated to [-2, 2]), so the token shift moves the streams;
    "init" leaves the weights as drawn."""
    from repro_torch.models.layers import truncated_normal_init

    gen = torch.Generator(device=model.device).manual_seed(seed + 11)
    with torch.no_grad():
        for layer in model.layers:
            if name == "clip":
                layer.tm_decay_base.fill_(1.0)
            elif name == "shift":
                for mu in (layer.tm_mu, layer.cm_mu):
                    mu.copy_(truncated_normal_init(
                        mu.shape, 0.5, generator=gen, device=mu.device))
            elif name != "init":
                raise ValueError(name)


def wkv_inputs(shape, clip: bool, seed: int, device):
    """fp32 r, k, v ~ N(0, 1) and logw of shape (B, S, H, hd): with the
    clip every rate at ``MAX_RATE`` (logw -0.9), else the init's rate
    exp(-6 + 2 N(0, 1)) under the same clip, as ``_log_decay`` gives it."""
    from repro_torch.models import rwkv6

    gen = torch.Generator(device=device).manual_seed(seed)
    r, k, v, z = (torch.randn(shape, generator=gen, device=device)
                  for _ in range(4))
    if clip:
        logw = torch.full(shape, -rwkv6.MAX_RATE, device=device)
    else:
        logw = -torch.exp(torch.clamp(rwkv6.DECAY_BASE + 2.0 * z, -20.0,
                                      rwkv6.LOG_MAX_RATE))
    u = torch.randn(shape[2:], generator=gen, device=device) * 0.5
    state = torch.randn((shape[0], shape[2], shape[3], shape[3]),
                        generator=gen, device=device)
    return r, k, v, logw, u, state


def wkv_chunk_vs_step(shape, clip: bool, seed: int, device) -> dict:
    """``wkv_chunked`` against a ``wkv_step`` loop over the same fp32 r, k,
    v, logw, bonus and state (``wkv_inputs``): the relative errors
    (``rel_err``) of y and of the final state, and each side's ms on the
    device's clock (host clock on the CPU)."""
    from repro_torch.models import rwkv6

    r, k, v, logw, u, state = wkv_inputs(shape, clip, seed, device)

    def clock(fn):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def step_loop():
        s, ys = state, []
        for t in range(shape[1]):
            y, s = rwkv6.wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, s)
            ys.append(y)
        return torch.stack(ys, dim=1), s

    with torch.inference_mode():
        rwkv6.wkv_chunked(r, k, v, logw, u, state)          # warm
        (yc, sc), chunk_ms = clock(lambda: rwkv6.wkv_chunked(
            r, k, v, logw, u, state))
        (ys, ss), step_ms = clock(step_loop)
    return {"y_rel": rel_err(yc, ys), "state_rel": rel_err(sc, ss),
            "finite": bool(torch.isfinite(yc).all() and torch.isfinite(sc).all()),
            "chunked_ms": chunk_ms, "step_loop_ms": step_ms}


def _rwkv_run(model, cfg, tokens, forced):
    """A prefill of ``tokens`` (B, S) and one decode step a column of
    ``forced`` (B, n), through ``forward`` as ``ServeEngine``'s steps call
    it. Returns (logits (1 + n, B, V) fp32, the state after the prefill,
    the state at the end), on the host."""
    from repro_torch.models.transformer import Runtime, forward

    dev, rt = model.device, Runtime()
    S = tokens.shape[1]

    def host(cache):
        # a copy: the decode steps update the cache in place
        return {k: t.to("cpu", torch.float32, copy=True)
                for k, t in cache.items()}
    with torch.inference_mode():
        lg, cache, _ = forward(model, cfg, torch.tensor(tokens, device=dev),
                               rt, mode="prefill")
        logits = [lg[:, -1].float().cpu()]
        after_prefill = host(cache)
        for i in range(forced.shape[1]):
            lg, cache, _ = forward(model, cfg, torch.tensor(
                forced[:, i:i + 1], device=dev), rt, mode="decode",
                cache=cache, cache_len=S + i)
            logits.append(lg[:, -1].float().cpu())
    return torch.stack(logits), after_prefill, host(cache)


def rwkv_card_vs_cpu(seed: int) -> None:
    """The reduced rwkv6-7b and its ``clip`` and ``shift`` variants on the
    card against the same bridged weights on the CPU: a prefill of 2 x 75
    tokens (three chunks, the last padded) and two decode steps. Logits
    within 5e-2 x their largest magnitude (bf16 activations, sums in other
    orders); the fp32 WKV state (``rel_err``) after the prefill and at the
    end within ``RWKV_STATE_REL`` at layer 0 and ``RWKV_STATE_REL_ALL``
    over every layer; no kernel launched on either side."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model

    cfg = get_config(RWKV_ARCH).reduced()
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, 75)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    failures = []
    for name in RWKV_VARIANTS:
        gpu = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
        rwkv_variant(gpu, name, seed)
        cpu = params_from_jax(params_to_jax(gpu), cfg, device="cpu")
        ops.reset_launches()
        lg_c, pre_c, end_c = _rwkv_run(gpu, cfg, tokens, forced)
        lg_h, pre_h, end_h = _rwkv_run(cpu, cfg, tokens, forced)
        launches = dict(ops.LAUNCHES)
        err = float((lg_c - lg_h).abs().max())
        scale = float(lg_h.abs().max())
        pairs = ((pre_c, pre_h), (end_c, end_h))
        wkv0 = max(rel_err(c["wkv"][0], h["wkv"][0]) for c, h in pairs)
        wkv = max(rel_err(c["wkv"], h["wkv"]) for c, h in pairs)
        shift = max(rel_err(c[k], h[k]) for c, h in pairs
                    for k in ("shift_tm", "shift_cm"))
        ok = (bool(torch.isfinite(lg_c).all()) and err <= 5e-2 * max(scale, 1.0)
              and wkv0 <= RWKV_STATE_REL and wkv <= RWKV_STATE_REL_ALL
              and not any(launches.values()))
        log("rwkv", card_vs_cpu=f"{cfg.name}/{name}",
            steps="prefill 2x75 + 2 decode", max_abs_err=f"{err:.6g}",
            logit_scale=f"{scale:.6g}", wkv_layer0_rel_err=f"{wkv0:.6g}",
            wkv_rel_err=f"{wkv:.6g}", shift_rel_err=f"{shift:.6g}",
            tolerance=f"5e-2 x max|logit|; WKV state in norm {RWKV_STATE_REL} "
                      f"at layer 0, {RWKV_STATE_REL_ALL} over all layers",
            kernel_launches=sum(launches.values()), ok=ok)
        if not ok:
            failures.append(name)
        del gpu, cpu
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"reduced rwkv6-7b on the card disagrees with the "
                         f"CPU path: {failures}")


def wkv_bound(shape, chunk: int = 32):
    """(bound ms, what bounds it) of ``wkv_chunked`` on fp32 inputs of
    ``shape`` (B, S, H, hd): r, k, v and logw read and y written once, the
    state read and written once; the products of the chunked form (two of
    C x C x hd and two of C x hd x hd a chunk and head) at the fp32 rate
    outside the tensor cores (TF32 is off)."""
    B, S, H, hd = shape
    C = min(chunk, S)
    n = -(-S // C)
    flops = 2 * B * n * H * C * (2 * C * hd + 2 * hd * hd)
    nbytes = 4 * (5 * B * S * H * hd + 2 * B * H * hd * hd)
    return _bound(nbytes, flops, FP32_FLOPS)


def rwkv_chunk_check() -> None:
    """``wkv_chunk_vs_step`` at one full-width layer (``RWKV_CHUNK_CASE``)
    on the card, with and without the clip: y and the state within
    ``WKV_REL``; the chunked time beside its bound (``wkv_bound``)."""
    failures = []
    bound_ms, bound_by = wkv_bound(RWKV_CHUNK_CASE)
    for clip in (False, True):
        row = wkv_chunk_vs_step(RWKV_CHUNK_CASE, clip, 3, torch.device("cuda"))
        ok = (row["finite"] and row["y_rel"] <= WKV_REL
              and row["state_rel"] <= WKV_REL)
        log("rwkv", chunked_vs_step="x".join(map(str, RWKV_CHUNK_CASE)),
            clip=clip, y_rel_err=f"{row['y_rel']:.6g}",
            state_rel_err=f"{row['state_rel']:.6g}", tolerance=WKV_REL,
            chunked_ms=f"{row['chunked_ms']:.3f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            share_of_bound=f"{bound_ms / row['chunked_ms']:.4f}",
            step_loop_ms=f"{row['step_loop_ms']:.3f}", ok=ok)
        if not ok:
            failures.append(f"clip={clip}")
    if failures:
        raise SystemExit(f"wkv_chunked disagrees with the wkv_step loop: "
                         f"{failures}")


def _ranged(fn, name: str):
    """``fn`` wrapped in the profiler range ``name`` (``rwkv6.wkv_chunked``
    in ``WKV_RANGE``, the encoder in ``ENCODE_RANGE``, ...), with the host
    seconds its calls take summed into ``wrapped.host_s``."""
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            out = fn(*a, **kw)
        wrapped.host_s += time.perf_counter() - t0
        return out
    wrapped.host_s = 0.0
    return wrapped


def _range_device_ms(prof, name: str) -> float:
    """Device ms of the kernels launched inside the host ranges ``name``
    (the profiler correlates each kernel with the call that launched it)."""
    from torch.autograd import DeviceType

    def kernels_us(e):
        return (sum(k.duration for k in getattr(e, "kernels", []))
                + sum(kernels_us(c) for c in e.cpu_children))
    return sum(kernels_us(e) for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) / 1e3


def rwkv_profiles(eng, tokens) -> None:
    """A profiled prefill of ``tokens`` (wall, device busy time, the WKV's
    device and host shares: the calls of ``wkv_chunked``, 32 a prefill),
    then ``RWKV_PROFILE_STEPS`` profiled decode steps after two plain ones
    (busy, idle share, device operations a step)."""
    from repro_torch.models import rwkv6

    real = rwkv6.wkv_chunked
    rwkv6.wkv_chunked = wrapped = _ranged(real, WKV_RANGE)
    state = {}

    def prefill():
        wrapped.host_s = 0.0
        t0 = time.perf_counter()
        state["out"] = eng.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    try:
        prof, wall_ms = profiled(prefill, "the rwkv prefill", cpu=True)
    finally:
        rwkv6.wkv_chunked = real
    kernels = {} if prof is None else {
        n: v for n, v in _kernel_time_by_name(prof, 1).items()
        if n != WKV_RANGE}
    busy = sum(ms for ms, _ in kernels.values()) if kernels else NOT_MEASURED
    wkv = NOT_MEASURED if prof is None else _range_device_ms(prof, WKV_RANGE)
    log("rwkv", profile="prefill", batch=tokens.shape[0], seq=tokens.shape[1],
        profiled_prefill_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy:.3f}", idle_share=f"{1 - busy / wall_ms:.4f}",
        device_ops=sum(n for _, n in kernels.values()),
        wkv_device_ms=f"{wkv:.3f}", wkv_share_of_busy=f"{wkv / busy:.4f}",
        wkv_host_ms=f"{wrapped.host_s * 1e3:.3f}",
        wkv_host_share_of_wall=f"{wrapped.host_s * 1e3 / wall_ms:.4f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]:
        log("rwkv", profile="prefill", ms=f"{ms:.4f}",
            share=f"{ms / busy:.4f}", launches=n, kernel=f"'{name[:90]}'")

    logits, cache, _ = state.pop("out")
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = tokens.shape[1]
    for _ in range(2):
        tok, _, cache, _ = eng.decode(tok, cache, pos)
        pos += 1
    torch.cuda.synchronize()

    def steps():
        nonlocal tok, cache, pos
        t0 = time.perf_counter()
        for _ in range(RWKV_PROFILE_STEPS):
            tok, _, cache, _ = eng.decode(tok, cache, pos)
            pos += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / RWKV_PROFILE_STEPS

    prof, wall_ms = profiled(steps, "the rwkv decode step", cpu=True)
    kernels = {} if prof is None else _kernel_time_by_name(
        prof, RWKV_PROFILE_STEPS)
    busy = sum(ms for ms, _ in kernels.values()) if kernels else NOT_MEASURED
    log("rwkv", profile="decode", decode_steps=RWKV_PROFILE_STEPS,
        profiled_step_ms=f"{wall_ms:.3f}",
        device_busy_ms_per_step=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall_ms:.4f}",
        device_ops_per_step=f"{sum(n for _, n in kernels.values()) / RWKV_PROFILE_STEPS:.1f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]:
        log("rwkv", profile="decode", ms_per_step=f"{ms:.4f}",
            share=f"{ms / busy:.4f}", per_step=f"{n / RWKV_PROFILE_STEPS:.1f}",
            kernel=f"'{name[:90]}'")
    del cache, logits


def rwkv_serve(seed: int, smi: str) -> list:
    """rwkv6-7b at published widths and all 32 layers, random bf16 weights
    from ``seed``, through ``ServeEngine`` (strategy none): one batch of
    ``RWKV_SERVE`` Zipf prompts (``token_batches(seed)``). Prefill ms,
    decode step p50 and tokens/s (each step synchronised), peak memory;
    every request's tokens in range, every logit finite, no kernel
    launched (a first, cold prefill timed apart). Then ``rwkv_profiles``.
    Returns failures."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import _layer_shapes, init_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg, a = get_config(RWKV_ARCH), RWKV_SERVE
    n_held = sum(int(np.prod(shape)) for shape, _, _ in _layer_shapes(
        cfg, "rwkv").values()) * cfg.num_layers \
        + 2 * cfg.vocab_size * cfg.d_model
    log("rwkv", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, params_formula=cfg.num_params(),
        params_held=n_held,
        wkv_state_bytes_per_request=4 * cfg.num_layers * cfg.num_heads
        * cfg.head_dim ** 2,
        reduced="'none: published widths, all 32 layers'")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    log("rwkv", model=cfg.name, init_s=f"{time.perf_counter() - t0:.3f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    tokens = next(token_batches(seed, cfg.vocab_size, a["batch"],
                                a["seq"]))["tokens"]
    eng = ServeEngine(cfg, model, ServeConfig(
        strategy="none", max_len=a["seq"] + a["new_tokens"]))
    # the first prefill meets cuBLAS's first calls at these shapes: timed
    # apart, the run's own prefill is a warm one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill({"tokens": tokens})
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    rec = {"prefill_ms": [], "decode_ms": [], "finite": True}
    prefill, decode = eng.prefill, eng.decode

    def timed(fn, key, logits_at):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t1) * 1e3)
            rec["finite"] &= bool(torch.isfinite(out[logits_at]).all())
            return out
        return run
    eng.prefill = timed(prefill, "prefill_ms", 0)
    eng.decode = timed(decode, "decode_ms", 1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, tele = eng.generate({"tokens": tokens},
                             max_new_tokens=a["new_tokens"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eng.prefill, eng.decode = prefill, decode
    toks = out.cpu().numpy()
    dec = rec["decode_ms"]
    p50 = float(np.median(dec))
    log("rwkv", run=f"serve/{cfg.name}", card=f"'{smi}'", strategy="none",
        batch=a["batch"], seq=a["seq"], new_tokens=a["new_tokens"],
        first_prefill_ms=f"{first_ms:.3f}",
        prefill_ms=f"{rec['prefill_ms'][0]:.3f}", decode_steps=len(dec),
        decode_step_p50_ms=f"{p50:.3f}",
        decode_step_min_max_ms=f"{min(dec):.3f},{max(dec):.3f}",
        decode_toks_per_s=f"{a['batch'] / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}", logits_finite=rec["finite"],
        kernel_launches=sum(launches.values()))
    failures = []
    if any(launches.values()):
        failures.append(f"serve: kernel launches {launches}")
    if toks.shape != (a["batch"], a["new_tokens"]) or (toks < 0).any() \
            or (toks >= cfg.vocab_size).any():
        failures.append(f"serve: bad tokens of shape {toks.shape}")
    if len(dec) != a["new_tokens"] - 1 or not rec["finite"] or tele != {}:
        failures.append(f"serve: {len(dec)} decode steps, finite "
                        f"{rec['finite']}, telemetry {tele}")
    rwkv_profiles(eng, tokens)
    del eng, model, prefill, decode        # (the bound methods hold eng)
    free_engines("rwkv")
    return failures


def rwkv_launch_serve(seed: int, smi: str) -> list:
    """``python -m repro_torch.launch.serve --arch rwkv6-7b`` (``main`` in
    this process, a fresh full-width model from ``seed``) on
    ``RWKV_LAUNCH``: exit 0, every request served, no kernel launched.
    Returns failures."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    a = RWKV_LAUNCH
    trace = os.path.join(ROOT, "build", "chip_smoke", "rwkv_launch_serve.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    argv = ["--arch", RWKV_ARCH, "--requests", str(a["requests"]),
            "--batch", str(a["batch"]), "--seq", str(a["seq"]),
            "--new-tokens", str(a["new_tokens"]), "--seed", str(seed),
            "--device", "cuda", "--trace-out", trace]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rc, out, spans = _launch(launch_serve, argv, "rwkv", trace)
    launches = dict(ops.LAUNCHES)
    decode = spans.get("decode", [])
    batches = a["requests"] // a["batch"]
    log("rwkv", run=f"launch.serve/{RWKV_ARCH}", card=f"'{smi}'",
        argv=f"'{' '.join(argv)}'", rc=rc,
        prefill_ms=",".join(f"{v:.3f}" for v in spans.get("prefill", [])),
        decode_steps=len(decode),
        decode_ms_p50=f"{np.median(decode):.3f}" if decode else "n/a",
        decode_toks_per_s=(f"{a['batch'] / np.median(decode) * 1e3:.2f}"
                           if decode else "n/a"),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        kernel_launches=sum(launches.values()))
    failures = []
    if rc != 0 or f"served {a['requests']} requests" not in out:
        failures.append(f"launch.serve {RWKV_ARCH}: exit {rc}")
    if any(launches.values()):
        failures.append(f"launch.serve {RWKV_ARCH}: launches {launches}")
    if len(decode) != batches * (a["new_tokens"] - 1):
        failures.append(f"launch.serve {RWKV_ARCH}: {len(decode)} decode "
                        "steps")
    free_engines("rwkv")
    return failures


def rwkv_train_run(seed: int, smi: str, layers: int) -> list:
    """``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` Zipf tokens
    (``token_batches(seed)``) through ``make_train_step`` at the launcher's
    schedule, rwkv6-7b at published widths cut to ``layers`` layers, fp32
    weights from ``seed``: per step loss, grad norm, lr and ms; step p50,
    tokens/s, peak memory, the model-FLOPs share of peak; no kernel
    launched; the loss falls, and so does one batch's repeated at a fixed
    lr from fresh moments; then ``train_breakdown`` (forward and backward
    against AdamW). Returns failures."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_lr_fn
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.train.steps import init_opt_state, make_train_step

    cfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=layers)
    run = f"rwkv/{cfg.name}/{layers}L"
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda", trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    log("rwkv", train=run, layers=layers, params_held=n_params,
        state_gb=f"{16 * n_params / 1e9:.3f}", batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, base_lr=TRAIN_LR,
        reduced=f"'{layers} of 32 layers (16 B a parameter: 32 layers "
                "would need 122 GB); widths as published'")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    opt = init_opt_state(model)
    step = make_train_step(cfg, Runtime(), lr_fn=build_lr_fn(
        cfg, TRAIN_LR, TRAIN_STEPS))
    gen = token_batches(seed, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = next(gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        log("rwkv", train=run, step=i, loss=f"{losses[-1]:.6f}",
            grad_norm=f"{float(m['grad_norm']):.6g}",
            lr=f"{float(m['lr']):.6g}", step_ms=f"{step_ms[-1]:.3f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(ops.LAUNCHES)
    p50 = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mflops = model_flops(cfg, InputShape("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    log("rwkv", train=run, card=f"'{smi}'", steps=len(step_ms),
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
        step_ms=",".join(f"{v:.3f}" for v in step_ms),
        step_ms_p50=f"{p50:.3f}", tokens_per_s=f"{tokens / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}", model_flops_per_step=f"{mflops:.6g}",
        model_flops_share_of_peak=f"{mflops / (p50 / 1e3 * PEAK_FLOPS):.6g}",
        note="6 x num_params() x tokens, the JAX formula (its time mix "
             "counts 3 d^2 of the 6.25 d^2 a layer holds)",
        kernel_launches=sum(launches.values()))
    failures = []
    if any(launches.values()):
        failures.append(f"train launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"train loss {losses[0]} -> {losses[-1]}")
    del opt, m
    gc.collect()
    torch.cuda.empty_cache()
    batch = next(token_batches(seed + 1, cfg.vocab_size, TRAIN_BATCH,
                               TRAIN_SEQ))
    rl = _dense_repeat(cfg, model, batch, remat=False)
    log("rwkv", train=run, repeat_batch_losses=",".join(
        f"{v:.6f}" for v in rl), lr=TRAIN_REPEAT_LR, falls=rl[-1] < rl[0])
    if not rl[-1] < rl[0]:
        failures.append(f"the repeated batch's loss did not fall: {rl}")
    opt = init_opt_state(model)
    train_breakdown(run, cfg, model, opt, batch)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def rwkv_train(seed: int, smi: str) -> list:
    """``rwkv_train_run`` at the first of ``RWKV_TRAIN_LAYERS`` that fits
    the card. Returns failures."""
    for layers in RWKV_TRAIN_LAYERS:
        t1 = time.perf_counter()
        try:
            failures = rwkv_train_run(seed, smi, layers)
        except torch.cuda.OutOfMemoryError as e:
            log("rwkv", train_layers=layers, out_of_memory=True,
                error=f"'{str(e).splitlines()[0][:160]}'")
            gc.collect()
            torch.cuda.empty_cache()
            continue
        log("rwkv", train_layers=layers,
            train_s=f"{time.perf_counter() - t1:.3f}")
        return failures
    raise SystemExit(f"rwkv: training ran out of memory at every depth of "
                     f"{RWKV_TRAIN_LAYERS}")


def rwkv_phase(seed: int, smi: str) -> None:
    """Phase rwkv: rwkv6-7b served through ``ServeEngine`` at all 32
    layers (``rwkv_serve``), through ``launch.serve`` (``rwkv_launch_
    serve``), trained at 8 of 32 layers (``rwkv_train``), its reduced
    config and variants card against CPU (``rwkv_card_vs_cpu``) and the
    chunked WKV against the stepwise one at a full-width layer
    (``rwkv_chunk_check``). Frees what earlier phases hold first."""
    free_engines("rwkv")
    t0 = time.perf_counter()
    failures = rwkv_serve(seed, smi)
    t1 = time.perf_counter()
    failures += rwkv_launch_serve(seed, smi)
    t2 = time.perf_counter()
    failures += rwkv_train(seed, smi)
    t3 = time.perf_counter()
    rwkv_card_vs_cpu(seed)
    rwkv_chunk_check()
    log("rwkv", serve_s=f"{t1 - t0:.3f}", launch_serve_s=f"{t2 - t1:.3f}",
        train_s=f"{t3 - t2:.3f}",
        checks_s=f"{time.perf_counter() - t3:.3f}",
        phase_s=f"{time.perf_counter() - t0:.3f}")
    if failures:
        raise SystemExit("rwkv failed: " + "; ".join(failures))


SEAMLESS_ARCH = "seamless-m4t-medium"
# 8 requests of 1024 frames (~20 s of speech at 50 frames/s) and a 64-token
# Zipf prompt each, 64 new tokens; then one batch at the encoder's
# max_source_len (the JAX launch specs' 4096 frames), 8 new tokens
SEAMLESS_SERVE = dict(batch=8, frames=1024, prompt=64, new_tokens=64)
SEAMLESS_LONG = dict(batch=8, frames=4096, prompt=64, new_tokens=8)
SEAMLESS_PROFILE_STEPS = 2
# 10 steps of 4 x 512 tokens over 4 x 1024 random frames, all 12 + 12
# layers (877.1e6 parameters: 14.0 GB of fp32 state)
SEAMLESS_TRAIN = dict(batch=4, seq=512, frames=1024, steps=10)
# the CPU tests' variants (tests/_torch_encdec.py): frames a row
SEAMLESS_VARIANTS = {"reduced": 40, "long": 600, "g1": 600}
SEAMLESS_CACHE_REL = 2e-2          # the cross cache, card vs CPU, in norm
SEAMLESS_ENC_REL = 1e-2            # the encoder's output, card vs CPU
ENCODE_RANGE = "chip_smoke.encode"
CROSS_RANGE = "chip_smoke.cross_decode"


def seamless_variant(reduced, name: str):
    """The CPU tests' variants of the reduced seamless config
    (``tests/_torch_encdec.py``): "reduced" and "long" as they are (40 and
    600 frames); "g1" with G 1 in both stacks, the encoder at 8 heads of 32
    (so RoPE at the decoder's width would show)."""
    if name in ("reduced", "long"):
        return reduced
    if name != "g1":
        raise ValueError(name)
    enc = dataclasses.replace(reduced.encoder, num_heads=8, num_kv_heads=8)
    return dataclasses.replace(reduced, num_kv_heads=reduced.num_heads,
                               encoder=enc)


def seamless_frames(seed: int, batch: int, frames: int, d: int, device):
    """(batch, frames, d) fp32 frames, a standard normal from ``seed``,
    drawn on ``device`` (zero frames would make the encoder's output 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, frames, d), generator=gen, device=device)


def seamless_held(cfg) -> int:
    """The parameters the model holds (``num_params()`` leaves out the
    cross-attention and the norms)."""
    from repro_torch.models.transformer import _layer_shapes

    def count(kind):
        return sum(int(np.prod(shape)) for shape, _, _ in
                   _layer_shapes(cfg, kind).values())
    return (count("decoder") * cfg.num_layers
            + count("encoder") * cfg.encoder.num_layers
            + 2 * cfg.vocab_size * cfg.d_model + cfg.d_model
            + cfg.encoder.d_model)


def seamless_profiles(eng, batch, label: str) -> None:
    """A profiled prefill of ``batch`` (wall, device busy time, idle share,
    the encoder's device and host shares: a profiler range around
    ``_encode``), then ``SEAMLESS_PROFILE_STEPS`` profiled decode steps
    after two plain ones (busy, idle share, device operations a step, the
    cross-attention's device share: a range around ``cross_decode``)."""
    from repro_torch.models import attention, transformer

    real_enc, real_cross = transformer._encode, attention.cross_decode
    transformer._encode = enc = _ranged(real_enc, ENCODE_RANGE)
    attention.cross_decode = cross = _ranged(real_cross, CROSS_RANGE)
    state = {}
    try:
        def prefill():
            enc.host_s = 0.0
            t0 = time.perf_counter()
            state["out"] = eng.prefill(batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        prof, wall_ms = profiled(prefill, f"the seamless {label} prefill",
                                 cpu=True)
        ranges = (ENCODE_RANGE, CROSS_RANGE)
        kernels = {} if prof is None else {
            n: v for n, v in _kernel_time_by_name(prof, 1).items()
            if n not in ranges}
        busy = (sum(ms for ms, _ in kernels.values()) if kernels
                else NOT_MEASURED)
        enc_ms = (NOT_MEASURED if prof is None
                  else _range_device_ms(prof, ENCODE_RANGE))
        log("seamless", profile=f"prefill/{label}",
            batch=batch["tokens"].shape[0],
            prompt=batch["tokens"].shape[1],
            frames=batch["frames"].shape[1],
            profiled_prefill_ms=f"{wall_ms:.3f}",
            device_busy_ms=f"{busy:.3f}",
            idle_share=f"{1 - busy / wall_ms:.4f}",
            device_ops=sum(n for _, n in kernels.values()),
            encoder_device_ms=f"{enc_ms:.3f}",
            encoder_share_of_busy=f"{enc_ms / busy:.4f}",
            encoder_host_ms=f"{enc.host_s * 1e3:.3f}",
            encoder_host_share_of_wall=f"{enc.host_s * 1e3 / wall_ms:.4f}")
        for name, (ms, n) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            log("seamless", profile=f"prefill/{label}", ms=f"{ms:.4f}",
                share=f"{ms / busy:.4f}", launches=n,
                kernel=f"'{name[:90]}'")

        logits, cache, _ = state.pop("out")
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = batch["tokens"].shape[1]
        for _ in range(2):
            tok, _, cache, _ = eng.decode(tok, cache, pos)
            pos += 1
        torch.cuda.synchronize()

        def steps():
            nonlocal tok, cache, pos
            cross.host_s = 0.0
            t0 = time.perf_counter()
            for _ in range(SEAMLESS_PROFILE_STEPS):
                tok, _, cache, _ = eng.decode(tok, cache, pos)
                pos += 1
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / SEAMLESS_PROFILE_STEPS

        n_steps = SEAMLESS_PROFILE_STEPS
        prof, wall_ms = profiled(steps, f"the seamless {label} decode step",
                                 cpu=True)
        kernels = {} if prof is None else {
            n: v for n, v in _kernel_time_by_name(prof, n_steps).items()
            if n not in ranges}
        busy = (sum(ms for ms, _ in kernels.values()) if kernels
                else NOT_MEASURED)
        cross_ms = (NOT_MEASURED if prof is None
                    else _range_device_ms(prof, CROSS_RANGE) / n_steps)
        log("seamless", profile=f"decode/{label}", decode_steps=n_steps,
            frames=batch["frames"].shape[1],
            profiled_step_ms=f"{wall_ms:.3f}",
            device_busy_ms_per_step=f"{busy:.3f}",
            idle_share=f"{1 - busy / wall_ms:.4f}",
            device_ops_per_step=f"{sum(n for _, n in kernels.values()) / n_steps:.1f}",
            cross_device_ms_per_step=f"{cross_ms:.3f}",
            cross_share_of_busy=f"{cross_ms / busy:.4f}",
            cross_host_ms_per_step=f"{cross.host_s * 1e3 / n_steps:.3f}",
            cross_cache_gb=f"{2 * cache['cross_k'].numel() * 2 / 1e9:.4f}")
        for name, (ms, n) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            log("seamless", profile=f"decode/{label}",
                ms_per_step=f"{ms:.4f}", share=f"{ms / busy:.4f}",
                per_step=f"{n / n_steps:.1f}", kernel=f"'{name[:90]}'")
        del cache, logits
    finally:
        transformer._encode, attention.cross_decode = real_enc, real_cross


def _timed(eng, rec: dict):
    """``eng.prefill`` / ``eng.decode`` wrapped to synchronise and time each
    call into ``rec["prefill_ms"]`` / ``rec["decode_ms"]`` and to AND the
    finiteness of its logits into ``rec["finite"]``. Returns the originals."""
    prefill, decode = eng.prefill, eng.decode

    def timed(fn, key, logits_at):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t1) * 1e3)
            rec["finite"] &= bool(torch.isfinite(out[logits_at]).all())
            return out
        return run
    eng.prefill = timed(prefill, "prefill_ms", 0)
    eng.decode = timed(decode, "decode_ms", 1)
    return prefill, decode


def seamless_generate(eng, cfg, batch, label: str, smi: str,
                      timed_first: bool) -> list:
    """``eng.generate(batch)``, each prefill and decode step synchronised
    and timed: prefill ms, decode step p50 and tokens/s, peak memory; every
    request's tokens in range, every logit finite, no kernel launched. A
    first, untimed-in-the-run prefill of the same batch comes first (cold
    for ``timed_first``). Returns failures."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill(batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    rec = {"prefill_ms": [], "decode_ms": [], "finite": True}
    new = eng.serve.max_len - batch["tokens"].shape[1]
    prefill, decode = _timed(eng, rec)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        out, tele = eng.generate(batch, max_new_tokens=new)
        torch.cuda.synchronize()
    finally:
        eng.prefill, eng.decode = prefill, decode
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = out.cpu().numpy()
    dec = rec["decode_ms"]
    p50 = float(np.median(dec))
    B = batch["tokens"].shape[0]
    log("seamless", run=f"serve/{cfg.name}/{label}", card=f"'{smi}'",
        strategy="none", batch=B, prompt=batch["tokens"].shape[1],
        frames=batch["frames"].shape[1], new_tokens=new,
        first_prefill_ms=f"{first_ms:.3f}", first_was_cold=timed_first,
        prefill_ms=f"{rec['prefill_ms'][0]:.3f}", decode_steps=len(dec),
        decode_step_p50_ms=f"{p50:.3f}",
        decode_step_min_max_ms=f"{min(dec):.3f},{max(dec):.3f}",
        decode_toks_per_s=f"{B / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}", logits_finite=rec["finite"],
        kernel_launches=sum(launches.values()))
    for r in range(B):
        log("seamless", run=f"serve/{cfg.name}/{label}", request=r,
            tokens=",".join(map(str, toks[r])))
    failures = []
    if any(launches.values()):
        failures.append(f"serve {label}: kernel launches {launches}")
    if toks.shape != (B, new) or (toks < 0).any() \
            or (toks >= cfg.vocab_size).any():
        failures.append(f"serve {label}: bad tokens of shape {toks.shape}")
    if len(dec) != new - 1 or not rec["finite"] or tele != {}:
        failures.append(f"serve {label}: {len(dec)} decode steps, finite "
                        f"{rec['finite']}, telemetry {tele}")
    return failures


def seamless_serve(seed: int, smi: str) -> list:
    """seamless-m4t-medium at published widths and all 12 + 12 layers,
    random bf16 weights from ``seed``, through ``ServeEngine`` (strategy
    none): ``SEAMLESS_SERVE`` (8 requests of 1024 random frames and a
    64-token Zipf prompt, 64 new tokens), then ``SEAMLESS_LONG`` (8 x 4096
    frames, 8 new tokens), each through ``seamless_generate`` and
    ``seamless_profiles``. Returns failures."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config(SEAMLESS_ARCH)
    enc = cfg.encoder
    log("seamless", model=cfg.name, layers=cfg.num_layers,
        enc_layers=enc.num_layers, d_model=cfg.d_model, heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, max_source_len=enc.max_source_len,
        params_formula=cfg.num_params(), params_held=seamless_held(cfg),
        cross_cache_bytes_per_frame=2 * cfg.num_layers * cfg.num_kv_heads
        * cfg.head_dim * 2,
        reduced="'none: published widths, all 12 + 12 layers'")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    log("seamless", model=cfg.name, init_s=f"{time.perf_counter() - t0:.3f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    failures = []
    for i, (label, a) in enumerate((("serve", SEAMLESS_SERVE),
                                    ("max_source_len", SEAMLESS_LONG))):
        batch = {"tokens": next(token_batches(seed + i, cfg.vocab_size,
                                              a["batch"], a["prompt"]))
                 ["tokens"],
                 "frames": seamless_frames(seed + i, a["batch"], a["frames"],
                                           enc.d_model, "cuda")}
        eng = ServeEngine(cfg, model, ServeConfig(
            strategy="none", max_len=a["prompt"] + a["new_tokens"]))
        failures += seamless_generate(eng, cfg, batch, label, smi,
                                      timed_first=i == 0)
        seamless_profiles(eng, batch, label)
        del eng, batch
        free_engines("seamless")
    del model
    free_engines("seamless")
    return failures


def seamless_encoder_grads(cfg, model, batch) -> dict:
    """One forward and backward of ``make_loss_fn`` on ``batch``: the
    gradient norms of the encoder's parameters, of the decoder's
    cross-attention and of everything, fp64 on the host; the gradients are
    cleared after."""
    from repro_torch.models.transformer import Runtime
    from repro_torch.train.steps import make_loss_fn

    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    loss, _ = make_loss_fn(cfg, Runtime())(model, batch)
    loss.backward()
    sums = dict.fromkeys(("encoder", "cross", "all"), 0.0)
    for n, p in model.named_parameters():
        g = float(p.grad.double().square().sum()) if p.grad is not None \
            else 0.0
        sums["all"] += g
        if n.startswith("enc_layers.") or n == "enc_norm":
            sums["encoder"] += g
        if ".cross_" in n or n.endswith(".ln_cross"):
            sums["cross"] += g
        p.grad = None
    return {k: float(np.sqrt(v)) for k, v in sums.items()}


def seamless_train(seed: int, smi: str) -> list:
    """Training at published widths and all 12 + 12 layers. First
    ``python -m repro_torch.launch.train --arch seamless-m4t-medium``
    (``main`` in this process: 10 steps of 4 x 512 Zipf tokens over the
    launcher's zero frames, step times from its trace), held to what the
    JAX launcher does there: zero frames make every encoder activation 0,
    each of the encoder's RMSNorms then passes the gradient on times
    1/sqrt(eps) = 1000, and over 12 layers it overflows (so do 8 at
    reduced widths, in both packages: ``tests/test_torch_encdec_train.py``),
    so step 0's
    loss is finite, its gradient norm NaN, the weights turn NaN and the
    launcher exits 1 (ROADMAP.md §3). Then
    ``SEAMLESS_TRAIN`` through ``make_train_step`` at the launcher's
    schedule, fp32 weights from ``seed``, every step's frames a random
    normal: per step loss, grad norm, lr and ms; step p50, tokens/s, peak
    memory, the model-FLOPs share of peak; no kernel launched; the loss
    falls, and so does one batch's repeated at a fixed lr from fresh
    moments; the encoder's and the cross-attention's gradients nonzero on
    that batch; then ``train_breakdown``. Returns failures."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.train import build_lr_fn
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.train.steps import init_opt_state, make_train_step

    cfg, a = get_config(SEAMLESS_ARCH), SEAMLESS_TRAIN
    failures = []
    trace = os.path.join(ROOT, "build", "chip_smoke",
                         "seamless_launch_train.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    argv = ["--arch", SEAMLESS_ARCH, "--steps", str(a["steps"]),
            "--batch", str(a["batch"]), "--seq", str(a["seq"]),
            "--lr", str(TRAIN_LR), "--log-every", "1", "--seed", str(seed),
            "--device", "cuda", "--trace-out", trace]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rc, out, spans = _launch(launch_train, argv, "seamless", trace)
    steps = spans.get("train_step", [])
    first = next(line for line in out.splitlines()
                 if line.startswith("step    0 "))
    loss0 = float(first.split("loss=")[1].split()[0])
    gnorm0 = float(first.split("gnorm=")[1].split()[0])
    as_reference = rc == 1 and np.isfinite(loss0) and np.isnan(gnorm0)
    log("seamless", run=f"launch.train/{SEAMLESS_ARCH}", card=f"'{smi}'",
        argv=f"'{' '.join(argv)}'", rc=rc, step0_loss=loss0,
        step0_grad_norm=gnorm0, as_the_jax_launcher=as_reference,
        frames="zeros (batch, 64, 1024) bf16, the JAX launcher's",
        step_ms=",".join(f"{v:.3f}" for v in steps),
        step_ms_p50=f"{np.median(steps[1:]):.3f}" if len(steps) > 1
        else "n/a",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        kernel_launches=sum(ops.LAUNCHES.values()))
    if not as_reference or any(ops.LAUNCHES.values()):
        failures.append(f"launch.train {SEAMLESS_ARCH}: exit {rc}, step 0 "
                        f"loss {loss0} grad norm {gnorm0} (the JAX "
                        "launcher: exit 1, a finite loss, a NaN norm), "
                        f"launches {dict(ops.LAUNCHES)}")
    free_engines("seamless")

    run = f"seamless/{cfg.name}"
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda", trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    log("seamless", train=run, layers=cfg.num_layers,
        enc_layers=cfg.encoder.num_layers, params_held=n_params,
        state_gb=f"{16 * n_params / 1e9:.3f}", batch=a["batch"],
        seq=a["seq"], frames=a["frames"], steps=a["steps"], base_lr=TRAIN_LR,
        reduced="'none: published widths, all 12 + 12 layers'")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    opt = init_opt_state(model)
    step = make_train_step(cfg, Runtime(), lr_fn=build_lr_fn(
        cfg, TRAIN_LR, a["steps"]))
    gen = token_batches(seed, cfg.vocab_size, a["batch"], a["seq"])
    step_ms, losses = [], []
    for i in range(a["steps"]):
        batch = dict(next(gen), frames=seamless_frames(
            seed + 100 + i, a["batch"], a["frames"], cfg.encoder.d_model,
            "cuda"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        log("seamless", train=run, step=i, loss=f"{losses[-1]:.6f}",
            grad_norm=f"{float(m['grad_norm']):.6g}",
            lr=f"{float(m['lr']):.6g}", step_ms=f"{step_ms[-1]:.3f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(ops.LAUNCHES)
    p50 = float(np.median(step_ms[1:]))
    tokens = a["batch"] * a["seq"]
    mflops = model_flops(cfg, InputShape("train", a["seq"], a["batch"],
                                         "train"))
    log("seamless", train=run, card=f"'{smi}'", steps=len(step_ms),
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
        step_ms=",".join(f"{v:.3f}" for v in step_ms),
        step_ms_p50=f"{p50:.3f}", tokens_per_s=f"{tokens / p50 * 1e3:.2f}",
        frames_per_s=f"{a['batch'] * a['frames'] / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}", model_flops_per_step=f"{mflops:.6g}",
        model_flops_share_of_peak=f"{mflops / (p50 / 1e3 * PEAK_FLOPS):.6g}",
        note="6 x num_params() x decoder tokens, the JAX formula (it counts "
             "the encoder's weights at the decoder's tokens, and neither "
             "the cross-attention nor the frames)",
        kernel_launches=sum(launches.values()))
    if any(launches.values()):
        failures.append(f"train launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"train loss {losses[0]} -> {losses[-1]}")
    del opt, m
    gc.collect()
    torch.cuda.empty_cache()
    batch = dict(next(token_batches(seed + 1, cfg.vocab_size, a["batch"],
                                    a["seq"])),
                 frames=seamless_frames(seed + 1, a["batch"], a["frames"],
                                        cfg.encoder.d_model, "cuda"))
    norms = seamless_encoder_grads(cfg, model, batch)
    log("seamless", train=run, **{f"grad_norm_{k}": f"{v:.6g}"
                                  for k, v in norms.items()})
    if not (np.isfinite(norms["all"]) and norms["encoder"] > 0
            and norms["cross"] > 0):
        failures.append(f"encoder / cross-attention gradients {norms}")
    rl = _dense_repeat(cfg, model, batch, remat=False)
    log("seamless", train=run, repeat_batch_losses=",".join(
        f"{v:.6f}" for v in rl), lr=TRAIN_REPEAT_LR, falls=rl[-1] < rl[0])
    if not rl[-1] < rl[0]:
        failures.append(f"the repeated batch's loss did not fall: {rl}")
    opt = init_opt_state(model)
    train_breakdown(run, cfg, model, opt, batch)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def _seamless_run(model, cfg, tokens, frames, forced):
    """The encoder's output over ``frames``, a prefill of ``tokens`` (B, S)
    and one decode step a column of ``forced`` (B, n), through ``forward``
    as ``ServeEngine``'s steps call it. Returns (logits (1 + n, B, V) fp32,
    the encoder's output fp32, the cross cache {"cross_k", "cross_v"}
    fp32), on the host."""
    from repro_torch.models.transformer import (Runtime, _encode, forward,
                                                init_cache)

    dev, rt = model.device, Runtime()
    B, S = tokens.shape
    f = torch.tensor(frames, device=dev)
    with torch.inference_mode():
        enc = _encode(model, cfg, f).to("cpu", torch.float32, copy=True)
        cache = init_cache(cfg, rt, B, S + forced.shape[1], device=dev)
        lg, cache, _ = forward(model, cfg, torch.tensor(tokens, device=dev),
                               rt, mode="prefill", cache=cache, frames=f)
        logits = [lg[:, -1].float().cpu()]
        for i in range(forced.shape[1]):
            lg, cache, _ = forward(model, cfg, torch.tensor(
                forced[:, i:i + 1], device=dev), rt, mode="decode",
                cache=cache, cache_len=S + i)
            logits.append(lg[:, -1].float().cpu())
    cross = {k: cache[k].to("cpu", torch.float32, copy=True)
             for k in ("cross_k", "cross_v")}
    return torch.stack(logits), enc, cross


def seamless_card_vs_cpu(seed: int) -> None:
    """The reduced seamless config and its ``long`` (600 frames: two key
    blocks, the second padded) and ``g1`` (G 1, the encoder at 8 heads of
    32, 600 frames) variants on the card against the same bridged weights
    on the CPU: the encoder's output, a prefill of 2 x 24 tokens and two
    decode steps. Logits within 5e-2 x their largest magnitude (bf16
    activations, sums in other orders), the encoder's output within
    ``SEAMLESS_ENC_REL`` and the cross cache within ``SEAMLESS_CACHE_REL``
    in norm (``rel_err``), no kernel launched on either side."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model

    failures = []
    for name, n_frames in SEAMLESS_VARIANTS.items():
        cfg = seamless_variant(get_config(SEAMLESS_ARCH).reduced(), name)
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        forced = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
        frames = rng.normal(size=(2, n_frames, cfg.encoder.d_model)).astype(
            np.float32)
        gpu = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
        cpu = params_from_jax(params_to_jax(gpu), cfg, device="cpu")
        ops.reset_launches()
        lg_c, enc_c, cross_c = _seamless_run(gpu, cfg, tokens, frames, forced)
        lg_h, enc_h, cross_h = _seamless_run(cpu, cfg, tokens, frames, forced)
        launches = dict(ops.LAUNCHES)
        err = float((lg_c - lg_h).abs().max())
        scale = float(lg_h.abs().max())
        enc = rel_err(enc_c, enc_h)
        cross = max(rel_err(cross_c[k], cross_h[k]) for k in cross_c)
        ok = (bool(torch.isfinite(lg_c).all()) and err <= 5e-2 * max(scale, 1.0)
              and enc <= SEAMLESS_ENC_REL and cross <= SEAMLESS_CACHE_REL
              and tuple(cross_c["cross_k"].shape)[2] == n_frames
              and not any(launches.values()))
        log("seamless", card_vs_cpu=f"{cfg.name}/{name}", frames=n_frames,
            kv_heads=cfg.num_kv_heads, enc_heads=cfg.encoder.num_heads,
            steps="prefill 2x24 + 2 decode", max_abs_err=f"{err:.6g}",
            logit_scale=f"{scale:.6g}", encoder_rel_err=f"{enc:.6g}",
            cross_cache_rel_err=f"{cross:.6g}",
            tolerance=f"5e-2 x max|logit|; encoder {SEAMLESS_ENC_REL}, "
                      f"cross cache {SEAMLESS_CACHE_REL} in norm",
            kernel_launches=sum(launches.values()), ok=ok)
        if not ok:
            failures.append(name)
        del gpu, cpu
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"reduced seamless-m4t-medium on the card disagrees "
                         f"with the CPU path: {failures}")


def seamless_phase(seed: int, smi: str) -> None:
    """Phase seamless: seamless-m4t-medium served through ``ServeEngine``
    at all 12 + 12 layers (``seamless_serve``), trained through
    ``launch.train`` and ``make_train_step`` (``seamless_train``), its
    reduced config and variants card against CPU
    (``seamless_card_vs_cpu``). Frees what earlier phases hold first."""
    free_engines("seamless")
    t0 = time.perf_counter()
    failures = seamless_serve(seed, smi)
    t1 = time.perf_counter()
    failures += seamless_train(seed, smi)
    t2 = time.perf_counter()
    seamless_card_vs_cpu(seed)
    log("seamless", serve_s=f"{t1 - t0:.3f}", train_s=f"{t2 - t1:.3f}",
        checks_s=f"{time.perf_counter() - t2:.3f}",
        phase_s=f"{time.perf_counter() - t0:.3f}")
    if failures:
        raise SystemExit("seamless failed: " + "; ".join(failures))


LLAVA_ARCH = "llava-next-34b"
# ServeEngine: 2 requests of 2880 prefix embeddings (5 anyres tiles x 576
# patches, the config's P) and a 64-token Zipf prompt each, 32 decode steps
# at the true positions P + S + t; then generate's 8 tokens (positions
# S + t, the reference's)
LLAVA_SERVE = dict(batch=2, prompt=64, new_tokens=32)
LLAVA_GENERATE = 8
LLAVA_PROFILE_STEPS = 2
# ContinuousEngine, text only, on the same weights: 8 requests of 64 tokens,
# 32 new each, the paged pool of 8 slots x 96 positions
LLAVA_CCFG = dict(max_slots=8, prefill_len=64, block_size=16, max_len=96,
                  predict_interval=8)
LLAVA_TRACE = dict(requests=8, prompt=(64, 65), new_tokens=32, gap=0.0)
LLAVA_PROFILE_PROMPT = 32          # profile_phase's refills fit max_len 96
# the kernel at the engine's pool shape: 8 slots, M 6 blocks of 16, the
# decode lengths the run walks through (64 ... 95)
LLAVA_PAGED_LENGTHS = list(range(64, 96, 4))
# 10 train steps of 2 x (2880 random prefix embeddings + 512 tokens) at 4
# of 60 layers, each layer recomputed in the backward (without it each
# layer keeps ~13 GB of the chunked attention's 7 x 7 block intermediates);
# 16 B a parameter: 50.4 GB of state, and every run peaked at 65.04 GB of
# 80 (PERF.md), so an out-of-memory error fails the phase
LLAVA_TRAIN = dict(batch=2, seq=512, steps=10, layers=4)
# on an H100: at TRAIN_LR (3e-4) the launcher's warmup reached 1.8e-4 by
# step 6 and the 4-layer, 7168-wide model diverged there (loss 11.4 ->
# 19.1, grad norm 817); at 1e-4 the loss fell (11.4 -> 8.9) but the
# gradient norm grew from 43 to 313, and the repeated batch at
# TRAIN_REPEAT_LR (1e-5) then jumped from 11.8 to 26.1 in one step; at 5e-5
# with a repeat lr of 1e-6 the repeated batch went 9.86 -> 8.05 -> 9.71 ->
# 9.77, and at 3e-7 9.86 -> 9.24 -> 8.65 -> 8.14: AdamW's first steps from
# fresh moments move every weight by about lr, and this model overshoots
# (PERF.md, the llava findings)
LLAVA_TRAIN_LR, LLAVA_REPEAT_LR = 5e-5, 3e-7
LLAVA_CACHE_REL = 2e-2             # the KV cache, card vs CPU, in norm
# "gather" against "fused": the two runs' decode logits at every step both
# took on the same tokens within 4 bf16 ulps at |logit| in [4, 8), and
# where a request's tokens differ, the gather run's token is the fused
# run's runner-up. The two attention paths agree within a bf16 ulp a layer
# (the kernel case's 0.00195) and 60 layers carry that into the logits: on
# an H100 each request's largest difference read 0.0625-0.0859 over 145
# steps of 64000 logits, where 5e-2 had been predicted (PERF.md, llava)
LLAVA_GATHER_ATOL = 2.0 ** -3


def llava_variants():
    """The CPU tests' configs and inputs of the VLM backbone
    (``tests/_torch_vlm.py``, loaded from its file): ``VARIANTS``,
    ``PREFIX`` (prefix embeddings a row) and ``vlm_config``, which makes
    "reduced" (G 2, head_dim 64, 8 prefix embeddings) and "wide" (14 heads
    over 2 KV heads of 128, G 7, and 600 prefix embeddings, so P + S
    crosses a 512 block)."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "_torch_vlm.py")
    spec = importlib.util.spec_from_file_location("_torch_vlm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def llava_prefix(seed: int, batch: int, P: int, d: int, device):
    """(batch, P, d) fp32 prefix embeddings, 0.02 x a standard normal from
    ``seed`` (the token embeddings' scale), drawn on ``device`` (the
    launcher's zero prefix stays zero through every layer)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return 0.02 * torch.randn((batch, P, d), generator=gen, device=device)


def _event_timed(fn):
    """``fn`` with a CUDA event recorded before and after each call (pairs
    in ``wrapped.pairs``) and its host seconds summed into
    ``wrapped.host_s``: on one stream, the kernels between a pair are the
    call's, so the pairs' elapsed times sum its device time while the
    device runs behind the host."""
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        wrapped.pairs.append((start, end))
        wrapped.host_s += time.perf_counter() - t0
        return out
    wrapped.pairs, wrapped.host_s = [], 0.0
    return wrapped


def llava_profiles(eng, batch, pos: int) -> None:
    """A timed prefill of ``batch`` with CUDA events around each call of
    ``attention.chunked_attention`` (its device ms and host ms), then the
    same prefill under torch.profiler's device tracing alone (busy time,
    idle share, operations: tracing the host's operations too stretched a
    2.2 s prefill to 4.0 s, its 70578 device operations waiting on the
    tracer, and the idle share read 0.46), then
    ``LLAVA_PROFILE_STEPS`` profiled decode steps at ``pos`` on (busy,
    idle share, device operations a step)."""
    from repro_torch.models import attention

    real = attention.chunked_attention
    attention.chunked_attention = wrapped = _event_timed(real)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill(batch)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
    finally:
        attention.chunked_attention = real
    att = sum(a.elapsed_time(b) for a, b in wrapped.pairs)
    state = {}

    def prefill():
        t0 = time.perf_counter()
        state["out"] = eng.prefill(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    t1 = time.perf_counter()
    prof, wall_ms = profiled(prefill, "the llava prefill")
    kernels = {} if prof is None else _kernel_time_by_name(prof, 1)
    busy = sum(ms for ms, _ in kernels.values()) if kernels else NOT_MEASURED
    B, S = batch["tokens"].shape
    log("llava", profile="prefill", batch=B, prefix=batch[
        "prefix_embeds"].shape[1], prompt=S,
        timed_prefill_ms=f"{timed_ms:.3f}",
        profiled_prefill_ms=f"{wall_ms:.3f}", device_busy_ms=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall_ms:.4f}",
        device_ops=sum(n for _, n in kernels.values()),
        chunked_attention_calls=len(wrapped.pairs),
        chunked_attention_device_ms=f"{att:.3f}",
        chunked_attention_share_of_busy=f"{att / busy:.4f}",
        chunked_attention_host_ms=f"{wrapped.host_s * 1e3:.3f}",
        profile_s=f"{time.perf_counter() - t1:.3f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        log("llava", profile="prefill", ms=f"{ms:.4f}",
            share=f"{ms / busy:.4f}", launches=n, kernel=f"'{name[:90]}'")

    logits, cache, _ = state.pop("out")
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(2):
        tok, _, cache, _ = eng.decode(tok, cache, pos)
        pos += 1
    torch.cuda.synchronize()

    def steps():
        nonlocal tok, cache, pos
        t0 = time.perf_counter()
        for _ in range(LLAVA_PROFILE_STEPS):
            tok, _, cache, _ = eng.decode(tok, cache, pos)
            pos += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / LLAVA_PROFILE_STEPS

    n_steps = LLAVA_PROFILE_STEPS
    t1 = time.perf_counter()
    prof, wall_ms = profiled(steps, "the llava decode step")
    kernels = {} if prof is None else _kernel_time_by_name(prof, n_steps)
    busy = sum(ms for ms, _ in kernels.values()) if kernels else NOT_MEASURED
    log("llava", profile="decode", decode_steps=n_steps,
        profiled_step_ms=f"{wall_ms:.3f}",
        device_busy_ms_per_step=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall_ms:.4f}",
        device_ops_per_step=f"{sum(n for _, n in kernels.values()) / n_steps:.1f}",
        profile_s=f"{time.perf_counter() - t1:.3f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        log("llava", profile="decode", ms_per_step=f"{ms:.4f}",
            share=f"{ms / busy:.4f}", per_step=f"{n / n_steps:.1f}",
            kernel=f"'{name[:90]}'")
    del cache, logits


def llava_serve_engine(model, cfg, seed: int, smi: str) -> list:
    """``ServeEngine`` (strategy none) at all 60 layers on ``LLAVA_SERVE``:
    a cold prefill, then a timed one and 32 decode steps at the true
    positions P + S + t (prefill ms, decode step p50, decode tokens/s, peak
    memory, finite logits, tokens in range, no kernel launched: the linear
    cache decodes in plain PyTorch); ``llava_profiles``; then one
    ``generate`` of ``LLAVA_GENERATE`` tokens, the reference's parity path
    (its decode positions S + t lie inside the prefix). Returns failures."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServeEngine

    a, P = LLAVA_SERVE, cfg.num_prefix_embeddings
    B, S, T = a["batch"], a["prompt"], a["new_tokens"]
    batch = {"tokens": next(token_batches(seed, cfg.vocab_size, B, S))
             ["tokens"],
             "prefix_embeds": llava_prefix(seed, B, P, cfg.d_model, "cuda")}
    eng = ServeEngine(cfg, model, ServeConfig(strategy="none",
                                              max_len=P + S + T))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill(batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    rec = {"prefill_ms": [], "decode_ms": [], "finite": True}
    prefill, decode = _timed(eng, rec)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        logits, cache, _ = eng.prefill(batch)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = [tok]
        for t in range(T - 1):
            tok, _, cache, _ = eng.decode(tok, cache, P + S + t)
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu().numpy()
    finally:
        eng.prefill, eng.decode = prefill, decode
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    del cache, logits
    dec = rec["decode_ms"]
    p50 = float(np.median(dec))
    log("llava", run=f"serve/{cfg.name}", card=f"'{smi}'", strategy="none",
        batch=B, prefix=P, prompt=S, new_tokens=T,
        positions="P + S + t (the true ones)",
        first_prefill_ms=f"{first_ms:.3f}",
        prefill_ms=f"{rec['prefill_ms'][0]:.3f}",
        prefill_toks_per_s=f"{B * (P + S) / rec['prefill_ms'][0] * 1e3:.1f}",
        decode_steps=len(dec), decode_step_p50_ms=f"{p50:.3f}",
        decode_step_min_max_ms=f"{min(dec):.3f},{max(dec):.3f}",
        decode_toks_per_s=f"{B / p50 * 1e3:.2f}", kv_cache_gb=f"{cache_gb:.3f}",
        peak_gb=f"{peak_gb:.3f}", logits_finite=rec["finite"],
        kernel_launches=sum(launches.values()))
    for r in range(B):
        log("llava", run=f"serve/{cfg.name}", request=r,
            tokens=",".join(map(str, toks[r])))
    failures = []
    if any(launches.values()):
        failures.append(f"serve: kernel launches {launches}")
    if toks.shape != (B, T) or (toks < 0).any() \
            or (toks >= cfg.vocab_size).any():
        failures.append(f"serve: bad tokens of shape {toks.shape}")
    if len(dec) != T - 1 or not rec["finite"]:
        failures.append(f"serve: {len(dec)} decode steps, finite "
                        f"{rec['finite']}")
    llava_profiles(eng, batch, P + S)
    seen = []
    decode = eng.decode

    def spy(tok, cache, n):
        seen.append(n)
        return decode(tok, cache, n)
    eng.decode = spy
    t0 = time.perf_counter()
    try:
        gen, _ = eng.generate(batch, max_new_tokens=LLAVA_GENERATE)
        torch.cuda.synchronize()
    finally:
        eng.decode = decode
    gen = gen.cpu().numpy()
    log("llava", run=f"generate/{cfg.name}", new_tokens=LLAVA_GENERATE,
        wall_ms=f"{(time.perf_counter() - t0) * 1e3:.3f}",
        positions=",".join(map(str, seen)),
        note="ServeEngine.generate decodes at S + t, as the JAX engine does "
             "(ROADMAP.md section 3): inside the prefix here, so its tokens "
             "are the reference's parity path, not the true context's",
        first_token_as_true_run=bool((gen[:, 0] == toks[:, 0]).all()))
    if seen != [S + t for t in range(LLAVA_GENERATE - 1)] \
            or gen.shape != (B, LLAVA_GENERATE) \
            or not (gen[:, 0] == toks[:, 0]).all():
        failures.append(f"generate: positions {seen}, tokens {gen.shape}")
    del eng, batch
    free_engines("llava")
    return failures


def llava_paged_case(flush) -> dict:
    """``paged_decode_attention`` at the ContinuousEngine's pool shape (8
    slots, K 8, G 7, hd 128, blocks of 16, M 6, lengths 64 ... 92) held
    against its plain version and timed beside it, the library call and
    its bound (``_paged_case``); and the "gather" path at the same inputs
    (each slot's view gathered from its table, then
    ``kernels.ref.paged_decode_ref``), timed the same way."""
    from repro_torch.kernels import ref

    B, K, G, hd, bs = LLAVA_CCFG["max_slots"], 8, 7, 128, 16
    M = LLAVA_CCFG["max_len"] // bs
    gen = torch.Generator(device="cuda").manual_seed(11)
    dev = torch.device("cuda")
    N = 1 + B * M
    tab = (1 + torch.randperm(B * M, generator=gen, device=dev)
           .to(torch.int32)).reshape(B, M).contiguous()
    q, kp, vp = (torch.randn(shape, generator=gen, device=dev)
                 .to(torch.bfloat16) for shape in
                 ((B, K, G, hd), (N, bs, K, hd), (N, bs, K, hd)))
    lens = LLAVA_PAGED_LENGTHS
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    row = _paged_case(q, kp, vp, tab, lengths, lens, 0, flush, True)

    def gather():
        return ref.paged_decode_ref(q, ref.gather_view(kp, tab),
                                    ref.gather_view(vp, tab), lengths,
                                    block_size=bs)
    g_err = float((gather().float() - ref.paged_decode_plain(
        q, kp, vp, tab, lengths).float()).abs().max())
    row["gather_ms"] = time_ms(gather, flush)
    row["gather_max_abs_err"] = g_err
    row["ok"] = row["ok"] and g_err <= 1e-2
    log("kernels", kernel="paged_decode_attention", case="llava_g7_pool",
        dtype="bfloat16", window=0, shape=f"B{B}xK{K}xG{G}xhd{hd}xbs{bs}xM{M}",
        **{k: (f"{v:.6g}" if isinstance(v, float) else v)
           for k, v in row.items()})
    if not row["ok"]:
        raise SystemExit(f"paged_decode_attention disagrees with its plain "
                         f"version at llava's pool shape: {row}")
    return row


def llava_continuous(model, cfg, seed: int, smi: str) -> list:
    """``ContinuousEngine`` text only (tokens alone, as the JAX engine's
    requests carry) on the same weights: ``LLAVA_TRACE`` through
    ``serve_trace`` (completions, tokens, ``paged_decode_attention``
    exactly once a layer a decode step), ``profile_phase``'s decode steps
    (idle share), then the same trace with ``paged_attn_impl="gather"``:
    each decode step's logits (kept during both runs, ``_DecodeLogits``)
    within ``LLAVA_GATHER_ATOL`` of the fused run's wherever the two took
    the same tokens, the gather run's token the fused run's runner-up at a
    request's first difference, and no kernel launched. The kernel's case
    at this pool shape goes on the kernels line with the run's launches.
    Returns failures."""
    label = f"continuous/{cfg.name}"
    kept = _DecodeLogits()
    eng, launches = serve_trace(label, model, cfg, seed, ep=False,
                                phase="llava", strategy="none",
                                ccfg=LLAVA_CCFG, trace=LLAVA_TRACE,
                                on_start=kept.install)
    kept.uninstall(eng)
    n = MEASURED[f"serve/{label}"]
    steps = eng.decode_steps
    fused = {r.rid: list(r.generated) for r in eng.scheduler.completed}
    log("llava", run=label, card=f"'{smi}'",
        step_p50_ms=f"{n['step_p50_ms']:.3f}",
        ttft_p50_ms=f"{n['ttft_p50_ms']:.3f}",
        decode_toks_per_s=f"{n['decode_toks_per_s']:.2f}",
        peak_gb=f"{n['peak_gb']:.3f}", decode_steps=steps,
        paged_decode_attention_calls=launches["paged_decode_attention"],
        expected_calls=f"{steps}x{cfg.num_layers}")
    profile_phase(eng, cfg, seed, label, iters=LLAVA_PROFILE_STEPS,
                  prompt=LLAVA_PROFILE_PROMPT)
    del eng
    free_engines("llava")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    row = llava_paged_case(flush)
    del flush
    gcfg = dataclasses.replace(cfg, paged_attn_impl="gather")
    glabel = f"continuous_gather/{cfg.name}"
    gkept = _DecodeLogits()
    eng, glaunches = serve_trace(glabel, model, gcfg, seed, ep=False,
                                 phase="llava", strategy="none",
                                 ccfg=LLAVA_CCFG, trace=LLAVA_TRACE,
                                 on_start=gkept.install)
    gkept.uninstall(eng)
    g = MEASURED[f"serve/{glabel}"]
    gather = {r.rid: list(r.generated) for r in eng.scheduler.completed}
    rows = _gather_against_fused(kept.logits(), gkept.logits(), fused, gather)
    err = max(r["max_abs_err"] for r in rows)
    same = err <= LLAVA_GATHER_ATOL and all(
        r["runner_up"] for r in rows if r["first_difference"] is not None)
    log("llava", run=glabel, card=f"'{smi}'", paged_attn_impl="gather",
        step_p50_ms=f"{g['step_p50_ms']:.3f}",
        decode_toks_per_s=f"{g['decode_toks_per_s']:.2f}",
        decode_steps=eng.decode_steps,
        kernel_launches=sum(glaunches.values()),
        requests_equal_fused=sum(r["first_difference"] is None
                                 for r in rows),
        requests=len(rows), steps_compared=sum(r["steps"] for r in rows),
        max_abs_logit_err=f"{err:.6g}", atol=LLAVA_GATHER_ATOL,
        first_differences=",".join(
            f"rid{r['rid']}@{r['first_difference']}:gap{r['gap']:.4g}"
            f":top{r['top']:.4g}:runner_up{int(r['runner_up'])}"
            for r in rows if r["first_difference"] is not None) or "none",
        per_request_err=",".join(f"{r['max_abs_err']:.4g}" for r in rows),
        as_fused=same)
    del eng
    free_engines("llava")
    MEASURED["llava_paged_case"] = dict(
        {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "gather_ms")},
        shape="B8xK8xG7xhd128xbs16xM6", launches=launches[
            "paged_decode_attention"], decode_steps=steps,
        layers=cfg.num_layers)
    failures = []
    if launches["paged_decode_attention"] != steps * cfg.num_layers:
        failures.append(f"continuous: {launches} for {steps} decode steps")
    if not same or any(glaunches.values()):
        failures.append(f"gather: as fused {same} (largest logit difference "
                        f"{err}, first differences {rows}), launches "
                        f"{glaunches}")
    return failures


class _DecodeLogits:
    """Keeps, during a ``ContinuousEngine`` run, each decode step's logits
    (the step's own output, on the device; nothing read back during the
    run), keyed by the request and the index in its ``generated`` of the
    token the step makes for it. ``install`` wraps the engine's decode step
    (``serve_trace``'s ``on_start``, after the warmup); ``uninstall`` puts
    it back."""

    def __init__(self):
        self.calls = []

    def install(self, eng) -> None:
        real = eng._decode_fn

        def decode_fn(model, tokens, pool, tables, lengths, active, *a, **kw):
            out = real(model, tokens, pool, tables, lengths, active, *a, **kw)
            keys = [(s, r.rid, len(r.generated))
                    for s, r in enumerate(eng.scheduler.slots) if r is not None]
            self.calls.append((keys, active, out[1][:, -1]))
            return out
        decode_fn.real = real
        eng._decode_fn = decode_fn

    @staticmethod
    def uninstall(eng) -> None:
        eng._decode_fn = eng._decode_fn.real

    def logits(self) -> dict:
        """{(rid, index): (V,) fp32 logits on the host} over the slots each
        step decoded."""
        out = {}
        for keys, active, logits in self.calls:
            act = active.reshape(-1).cpu().numpy()
            logits = logits.float().cpu().numpy()
            for s, rid, j in keys:
                if act[s]:
                    out[(rid, j)] = logits[s]
        return out


def _gather_against_fused(fl: dict, gl: dict, a: dict, b: dict) -> list:
    """One row a request of two runs' tokens (``a`` "fused", ``b``
    "gather") and decode logits (``fl``, ``gl``, ``_DecodeLogits``): the
    first index where its tokens differ (None where none does); the
    decode steps up to and including it, where both runs took the same
    tokens, and the largest |logit| difference over them; at the first
    difference, the fused run's top logit, its gap to the second, and
    whether ``b``'s token was that runner-up. A difference at index 0
    (the prefill's token, which no decode step makes) compares nothing and
    has no runner-up."""
    rows = []
    for rid in sorted(a):
        diff = np.nonzero(np.asarray(a[rid]) != np.asarray(b[rid]))[0]
        j = int(diff[0]) if len(diff) else None
        last = len(a[rid]) - 1 if j is None else j
        errs = [float(np.abs(fl[(rid, i)] - gl[(rid, i)]).max())
                for i in range(1, last + 1)]
        row = dict(rid=rid, first_difference=j, steps=len(errs),
                   max_abs_err=max(errs) if errs else float("inf"),
                   gap=float("nan"), top=float("nan"), runner_up=False)
        if j:
            ids = np.argsort(fl[(rid, j)])[::-1][:2]
            vals = fl[(rid, j)][ids]
            row.update(gap=float(vals[0] - vals[1]), top=float(vals[0]),
                       runner_up={int(t) for t in ids} == {a[rid][j],
                                                             b[rid][j]})
        rows.append(row)
    return rows


def llava_train(seed: int, smi: str) -> list:
    """``LLAVA_TRAIN`` through ``make_train_step`` (``remat``) at published
    widths and ``LLAVA_TRAIN["layers"]`` of 60, fp32 weights from ``seed``, each step's
    prefix random (``llava_prefix``): per step loss, grad norm, lr and ms;
    step p50, tokens/s, peak memory, the model-FLOPs share of peak by the
    JAX formula (text tokens only) and with the prefix's tokens counted;
    no kernel launched; the loss falls, and so does one batch's repeated at
    a fixed lr from fresh moments. Then one step on the launcher's zero
    prefix (bf16 zeros), held to the JAX step at this depth in the CPU
    test (``tests/test_torch_vlm_train.py``: finite at 4 layers, NaN at
    16): a finite loss and gradient norm. Returns failures."""
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_lr_fn
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.train.steps import init_opt_state, make_train_step

    a = LLAVA_TRAIN
    layers = a["layers"]
    cfg = dataclasses.replace(get_config(LLAVA_ARCH), num_layers=layers)
    P, B = cfg.num_prefix_embeddings, a["batch"]
    run = f"llava/{cfg.name}"
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda", trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    log("llava", train=run, layers=layers, params_held=n_params,
        state_gb=f"{16 * n_params / 1e9:.3f}", batch=B, prefix=P,
        seq=a["seq"], steps=a["steps"], base_lr=LLAVA_TRAIN_LR, remat=True,
        reduced=f"'depth: {layers} of 60 layers (16 B a parameter of fp32 "
                f"state), published widths'")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    opt = init_opt_state(model)
    step = make_train_step(cfg, Runtime(), lr_fn=build_lr_fn(
        cfg, LLAVA_TRAIN_LR, a["steps"]), remat=True)
    gen = token_batches(seed, cfg.vocab_size, B, a["seq"])
    step_ms, losses = [], []
    for i in range(a["steps"]):
        batch = dict(next(gen), prefix_embeds=llava_prefix(
            seed + 100 + i, B, P, cfg.d_model, "cuda"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        log("llava", train=run, step=i, loss=f"{losses[-1]:.6f}",
            grad_norm=f"{float(m['grad_norm']):.6g}",
            lr=f"{float(m['lr']):.6g}", step_ms=f"{step_ms[-1]:.3f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(ops.LAUNCHES)
    p50 = float(np.median(step_ms[1:]))
    text = B * a["seq"]
    mflops = model_flops(cfg, InputShape("train", a["seq"], B, "train"))
    with_prefix = mflops * (a["seq"] + P) / a["seq"]
    log("llava", train=run, card=f"'{smi}'", steps=len(step_ms),
        loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
        step_ms=",".join(f"{v:.3f}" for v in step_ms),
        step_ms_p50=f"{p50:.3f}", text_tokens_per_s=f"{text / p50 * 1e3:.2f}",
        all_positions_per_s=f"{B * (a['seq'] + P) / p50 * 1e3:.2f}",
        peak_gb=f"{peak_gb:.3f}", model_flops_per_step=f"{mflops:.6g}",
        model_flops_share_of_peak=f"{mflops / (p50 / 1e3 * PEAK_FLOPS):.6g}",
        with_prefix_share_of_peak=(
            f"{with_prefix / (p50 / 1e3 * PEAK_FLOPS):.6g}"),
        note="6 x num_params() x text tokens, the JAX formula (the prefix's "
             "2880 positions a row are left out); beside it the same with "
             "them counted",
        kernel_launches=sum(launches.values()))
    failures = []
    if any(launches.values()):
        failures.append(f"train launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"train loss {losses[0]} -> {losses[-1]}")
    del opt, m
    gc.collect()
    torch.cuda.empty_cache()
    batch = dict(next(token_batches(seed + 1, cfg.vocab_size, B, a["seq"])),
                 prefix_embeds=llava_prefix(seed + 1, B, P, cfg.d_model,
                                            "cuda"))
    rl = _dense_repeat(cfg, model, batch, remat=True, lr=LLAVA_REPEAT_LR)
    log("llava", train=run, repeat_batch_losses=",".join(
        f"{v:.6f}" for v in rl), lr=LLAVA_REPEAT_LR, falls=rl[-1] < rl[0])
    if not rl[-1] < rl[0]:
        failures.append(f"the repeated batch's loss did not fall: {rl}")
    batch["prefix_embeds"] = torch.zeros((B, P, cfg.d_model),
                                         dtype=torch.bfloat16, device="cuda")
    opt = init_opt_state(model)
    opt, m = make_train_step(cfg, Runtime(), lr_fn=lambda s: LLAVA_TRAIN_LR,
                             remat=True)(model, opt, batch)
    zl, zg = float(m["loss"]), float(m["grad_norm"])
    log("llava", train=run, zero_prefix_loss=f"{zl:.6f}",
        zero_prefix_grad_norm=f"{zg:.6g}",
        prefix="zeros (2, 2880, 7168) bf16, the launchers'",
        as_the_jax_step_at_this_depth=bool(np.isfinite(zl)
                                           and np.isfinite(zg)))
    if not (np.isfinite(zl) and np.isfinite(zg)):
        failures.append(f"zero prefix: loss {zl}, grad norm {zg} (the JAX "
                        f"step at {layers} layers: finite)")
    del model, opt, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    return failures


def _llava_run(model, cfg, tokens, prefix, forced):
    """A prefill of ``prefix`` (B, P, d) and ``tokens`` (B, S) into a fresh
    cache of P + S + n positions and one decode step a column of
    ``forced`` (B, n) at the true positions P + S + i, through ``forward``
    as ``ServeEngine``'s steps call it. Returns (logits (1 + n, B, V) fp32,
    the cache {"k", "v"} fp32), on the host."""
    from repro_torch.models.transformer import Runtime, forward, init_cache

    dev, rt = model.device, Runtime()
    B, S = tokens.shape
    P = prefix.shape[1]
    with torch.inference_mode():
        cache = init_cache(cfg, rt, B, P + S + forced.shape[1], device=dev)
        lg, cache, _ = forward(model, cfg, torch.tensor(tokens, device=dev),
                               rt, mode="prefill", cache=cache,
                               prefix_embeds=torch.tensor(prefix, device=dev))
        logits = [lg[:, -1].float().cpu()]
        for i in range(forced.shape[1]):
            lg, cache, _ = forward(model, cfg, torch.tensor(
                forced[:, i:i + 1], device=dev), rt, mode="decode",
                cache=cache, cache_len=P + S + i)
            logits.append(lg[:, -1].float().cpu())
    return torch.stack(logits), {k: cache[k].to("cpu", torch.float32,
                                                copy=True) for k in "kv"}


def llava_card_vs_cpu(seed: int) -> None:
    """The reduced llava config and its "wide" variant (``llava_variants``:
    G 7 at head_dim 128, 600 prefix embeddings, so P + S crosses a 512
    block) on the card against the same bridged weights on the CPU: a
    prefill of fp32 prefix embeddings and 2 x 24 tokens, then two decode
    steps at the true positions. Logits within 5e-2 x their largest magnitude (bf16
    activations, sums in other orders), the cache within
    ``LLAVA_CACHE_REL`` in norm, no kernel launched on either side."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model

    vlm = llava_variants()
    failures = []
    for name in vlm.VARIANTS:
        P = vlm.PREFIX[name]
        cfg = vlm.vlm_config(get_config(LLAVA_ARCH).reduced(), name)
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        forced = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
        prefix = (0.02 * rng.normal(size=(2, P, cfg.d_model))).astype(
            np.float32)
        gpu = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
        cpu = params_from_jax(params_to_jax(gpu), cfg, device="cpu")
        ops.reset_launches()
        lg_c, cache_c = _llava_run(gpu, cfg, tokens, prefix, forced)
        lg_h, cache_h = _llava_run(cpu, cfg, tokens, prefix, forced)
        launches = dict(ops.LAUNCHES)
        err = float((lg_c - lg_h).abs().max())
        scale = float(lg_h.abs().max())
        cache = max(rel_err(cache_c[k], cache_h[k]) for k in cache_c)
        ok = (bool(torch.isfinite(lg_c).all()) and err <= 5e-2 * max(scale, 1.0)
              and cache <= LLAVA_CACHE_REL
              and tuple(cache_c["k"].shape)[2] == P + 24 + 2
              and not any(launches.values()))
        log("llava", card_vs_cpu=f"{cfg.name}/{name}", prefix=P,
            heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            steps="prefill 2x(P+24) + 2 decode at P + 24 + i",
            max_abs_err=f"{err:.6g}", logit_scale=f"{scale:.6g}",
            cache_rel_err=f"{cache:.6g}",
            tolerance=f"5e-2 x max|logit|; cache {LLAVA_CACHE_REL} in norm",
            kernel_launches=sum(launches.values()), ok=ok)
        if not ok:
            failures.append(name)
        del gpu, cpu
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"reduced llava-next-34b on the card disagrees "
                         f"with the CPU path: {failures}")


def llava_phase(seed: int, smi: str) -> None:
    """Phase llava: llava-next-34b at published widths and all 60 layers
    (68.78 GB of bf16 weights) through ``ServeEngine`` with prefix
    embeddings (``llava_serve_engine``) and ``ContinuousEngine`` text only,
    fused and "gather" (``llava_continuous``), on one model object; then
    trained at 4 of 60 layers (``llava_train``), and its reduced config
    and variant card against CPU (``llava_card_vs_cpu``). Frees what
    earlier phases hold first."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model

    free_engines("llava")
    torch.cuda.empty_cache()
    free_b, total_b = torch.cuda.mem_get_info()
    cfg = get_config(LLAVA_ARCH)
    log("llava", model=cfg.name, card=f"'{smi}'", layers=cfg.num_layers,
        d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        prefix=cfg.num_prefix_embeddings, params=cfg.num_params(),
        weights_gb_bf16=f"{2 * cfg.num_params() / 1e9:.3f}",
        kv_bytes_per_position=2 * cfg.num_layers * cfg.num_kv_heads
        * cfg.head_dim * 2, free_gb=f"{free_b / 1e9:.3f}",
        total_gb=f"{total_b / 1e9:.3f}",
        reduced="'none: published widths, all 60 layers'")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    log("llava", model=cfg.name, init_s=f"{t1 - t0:.3f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    failures = llava_serve_engine(model, cfg, seed, smi)
    t2 = time.perf_counter()
    failures += llava_continuous(model, cfg, seed, smi)
    t3 = time.perf_counter()
    del model
    free_engines("llava")
    failures += llava_train(seed, smi)
    t4 = time.perf_counter()
    llava_card_vs_cpu(seed)
    log("llava", init_s=f"{t1 - t0:.3f}", serve_s=f"{t2 - t1:.3f}",
        continuous_s=f"{t3 - t2:.3f}", train_s=f"{t4 - t3:.3f}",
        checks_s=f"{time.perf_counter() - t4:.3f}",
        phase_s=f"{time.perf_counter() - t0:.3f}")
    if failures:
        raise SystemExit("llava failed: " + "; ".join(failures))


SWEEP_ARCH = "llama-moe-3.5b"      # all 32 layers at published widths
SWEEP_STRATEGIES = ("dist_only", "token_to_expert", "reschedule", "both")
SWEEP_MAX_ITERS = 400              # the full tier's: every point drains
SWEEP_OUT = os.path.join(ROOT, "chiprun_out", "sweep")


@contextlib.contextmanager
def _warmup_capture(rec: dict):
    """Record, at the end of every ``ContinuousEngine.warmup``, the engine
    and the launch counts so far: a sweep job builds its engine inside
    ``run_point``, and its decode steps are read from the engine after."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ContinuousEngine

    real = ContinuousEngine.warmup

    def warmup(self):
        out = real(self)
        rec["engine"] = self
        rec["warmup_launches"] = dict(ops.LAUNCHES)
        return out
    ContinuousEngine.warmup = warmup
    try:
        yield rec
    finally:
        ContinuousEngine.warmup = real


def _sweep_main(argv) -> str:
    """The sweep CLI's ``main(ARGV)`` in this process (the host-only
    commands, which need no process of their own); its output logged line
    by line. Returns its stdout; fails the phase on rc != 0."""
    import io

    from repro_torch.sweep.__main__ import main as sweep_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sweep_main(argv)
    for line in out.getvalue().splitlines():
        log("sweep", cli=argv[0], stdout=f"'{line}'")
    if rc != 0:
        raise SystemExit(f"sweep failed: {argv[0]} returned {rc}")
    return out.getvalue()


def _sweep_doc_failures(doc: dict, kind: str) -> list:
    """What a sweep job document on this card must show: ok, drained,
    every request completed, the device and the card's name."""
    m, c = doc.get("metrics", {}), doc.get("config", {})
    bad = []
    if not doc.get("ok"):
        why = doc.get("error", "the job reported not ok")
        bad.append(f"{doc.get('key')}: not ok ({why})")
    if c.get("device") != "cuda":
        bad.append(f"{doc.get('key')}: device {c.get('device')!r}")
    if c.get("device_name") != kind:
        bad.append(f"{doc.get('key')}: device_name {c.get('device_name')!r}")
    if m and m.get("completed") != m.get("submitted"):
        bad.append(f"{doc.get('key')}: {m.get('completed')} of "
                   f"{m.get('submitted')} requests completed")
    return bad


def _log_sweep_point(doc: dict, smi: str) -> None:
    m = doc["metrics"]
    log("sweep", point=doc["key"], card=f"'{smi}'",
        device=doc["config"]["device"], ok=doc["ok"],
        wall_s=f"{doc['wall_s']:.3f}", steps=int(m["steps"]),
        step_p50_ms=f"{m['step_p50_ms']:.3f}",
        step_p99_ms=f"{m['step_p99_ms']:.3f}",
        ttft_p50_virtual_s=f"{m['ttft_p50']:.4f}",
        time_scale=doc["config"]["time_scale"],
        decode_toks_per_s=f"{m['decode_toks_per_s']:.2f}",
        completed=f"{int(m['completed'])}/{int(m['submitted'])}",
        dropped_pairs=int(m["dropped_tokens"]),
        overflow_pairs=int(m["overflow_tokens"]),
        migration_replans=int(m["migration_replans"]),
        migration_bytes_moved=int(m["migration_bytes_moved"]),
        migration_rejected=int(m["migration_rejected"]),
        resched_plans=int(m["resched_plans"]))


def sweep_phase(seed: int, smi: str) -> None:
    """Phase sweep: the port's sweep harness as users call it. First
    ``python -m repro_torch.sweep run`` on the smoke spec's reduced
    Mixtral point at mesh 1x4 (workload skew_shift, dist_only, ``--device
    cuda``), with its report, history and traces under ``SWEEP_OUT``.
    Then llama-moe-3.5b at published widths and all 32 layers under
    every strategy value (dist_only, token_to_expert, reschedule, both;
    mesh 1x4, smoke engine shape): the dist_only point in this process
    through ``run_point`` with every kernel count set to 0 just before
    and read just after (held to its engine's warmup, prefills and decode
    steps), the other three through ``run_sweep``, one subprocess each,
    loading the kernels this script built. Every document must be ok on
    this card; then ``collect`` into a fresh history, ``report`` over it
    (one row per series) and the spec's k8s manifests (every one valid)."""
    import shutil

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.sweep import MeshShape, SweepSpec, validate_manifest
    from repro_torch.sweep.history import load_history, series
    from repro_torch.sweep.job import run_point
    from repro_torch.sweep.k8s import write_manifests
    from repro_torch.sweep.runner import _src_root, run_sweep

    free_engines("sweep")
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    shutil.rmtree(SWEEP_OUT, ignore_errors=True)
    os.makedirs(SWEEP_OUT)
    failures = []

    # 1. the CLI, as a user runs it, on the smoke spec's reduced Mixtral
    cli = {k: os.path.join(SWEEP_OUT, f) for k, f in (
        ("out", "SWEEP_cli_report.json"), ("history", "cli_history.jsonl"),
        ("trace-dir", "cli_traces"), ("merged-trace", "SWEEP_cli_trace.json"))}
    argv = (["run", "--smoke", "--mesh", "1x4", "--workload", "skew_shift",
             "--strategy", "dist_only", "--device", "cuda", "--max-iters",
             str(SWEEP_MAX_ITERS)]
            + [a for k, v in cli.items() for a in (f"--{k}", v)])
    env = dict(os.environ, PYTHONPATH=_src_root() + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    run = subprocess.run([sys.executable, "-m", "repro_torch.sweep", *argv],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    for line in run.stdout.splitlines():
        log("sweep", cli="run", stdout=f"'{line}'")
    if run.returncode != 0:
        raise SystemExit(f"sweep failed: python -m repro_torch.sweep "
                         f"{' '.join(argv)} exited {run.returncode}: "
                         f"{run.stderr.strip().splitlines()[-5:]}")
    with open(cli["out"]) as f:
        report = json.load(f)
    with open(cli["merged-trace"]) as f:
        trace_errors = validate_chrome_trace(json.load(f))
    for doc in report["jobs"].values():
        failures += _sweep_doc_failures(doc, kind)
        if doc.get("metrics"):
            _log_sweep_point(doc, smi)
    if len(report["jobs"]) != 1 or len(load_history(cli["history"])) != 1:
        failures.append(f"the CLI ran {len(report['jobs'])} points")
    if trace_errors:
        failures.append(f"the CLI's merged trace: {trace_errors[:3]}")
    t1 = time.perf_counter()

    # 2. llama-moe-3.5b at published widths under every strategy value
    cfg = get_config(SWEEP_ARCH)
    spec = SweepSpec(archs=(SWEEP_ARCH,), meshes=(MeshShape(1, 4),),
                     workloads=("skew_shift",), strategies=SWEEP_STRATEGIES,
                     seeds=(seed,), reduced=False)
    points = spec.expand()
    log("sweep", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        d_ff_expert=cfg.moe.d_ff_expert, vocab=cfg.vocab_size,
        points=",".join(p.key for p in points),
        max_iters=SWEEP_MAX_ITERS, reduced="'none: published widths, all "
        "32 layers; smoke engine shape and trace'")
    rec = {}
    with _warmup_capture(rec):
        ops.reset_launches()
        first = run_point(points[0], smoke=True, max_iters=SWEEP_MAX_ITERS,
                          device="cuda")
        launches = dict(ops.LAUNCHES)
    eng = rec.pop("engine")
    decode_steps, warm = eng.decode_steps, rec.pop("warmup_launches")
    del eng
    free_engines("sweep")
    m = first["metrics"]
    prefills = int(m["submitted"] + m["preemptions"])  # a preempted one refills
    want_warm = expected_launches(warm, cfg, 1, 1, ep=True)
    serving = {k: launches[k] - warm.get(k, 0) for k in launches}
    want = expected_launches(serving, cfg, prefills, decode_steps, ep=True)
    log("sweep", point=first["key"], prefills=prefills,
        decode_steps=decode_steps, iterations=int(m["steps"]),
        launches=",".join(f"{k}:{launches[k]}" for k in SERVING_KERNELS),
        warmup_launches=",".join(f"{k}:{warm[k]}" for k in SERVING_KERNELS),
        serving_launches=",".join(f"{k}:{serving[k]}"
                                  for k in SERVING_KERNELS),
        launches_exact=serving == want and warm == want_warm)
    if serving != want or warm != want_warm:
        failures.append(f"{first['key']}: launches {serving} (warmup "
                        f"{warm}) != {want} (warmup {want_warm})")
    if any(serving[k] == 0 for k in SERVING_KERNELS):
        failures.append(f"{first['key']}: a kernel never launched {serving}")
    rest = run_sweep(points[1:], smoke=True,
                     out_path=os.path.join(SWEEP_OUT, "SWEEP_report.json"),
                     history_path=os.path.join(SWEEP_OUT, "history.jsonl"),
                     max_iters=SWEEP_MAX_ITERS, device="cuda")
    docs = [first] + [rest["jobs"][p.key] for p in points[1:]]
    for doc in docs:
        failures += _sweep_doc_failures(doc, kind)
        if doc.get("metrics"):
            _log_sweep_point(doc, smi)
    t2 = time.perf_counter()

    # 3. collect, report and manifests over the four documents
    results = os.path.join(SWEEP_OUT, "results")
    os.makedirs(results)
    for doc in docs:
        with open(os.path.join(results, doc["key"].replace("/", "_")
                               + ".json"), "w") as f:
            json.dump(doc, f)
    fresh = os.path.join(SWEEP_OUT, "collected.jsonl")
    out = _sweep_main(["collect", "--dir", results, "--history", fresh])
    entries = load_history(fresh)
    if sorted(e["key"] for e in entries) != sorted(p.key for p in points):
        failures.append(f"collect: {out.strip()}")
    trend_md = os.path.join(SWEEP_OUT, "trend.md")
    _sweep_main(["report", "--history", fresh, "--out", trend_md])
    with open(trend_md) as f:
        rows = [r for r in f.read().splitlines() if r.startswith("| sweep |")]
    n_series = len(series(entries))
    if len(rows) != n_series:
        failures.append(f"report: {len(rows)} rows for {n_series} series")
    paths = write_manifests(points, os.path.join(SWEEP_OUT, "k8s"),
                            image="repro-sweep:latest", smoke=True)
    manifest_errors = []
    for path in paths:
        with open(path) as f:
            text = f.read()
        try:
            manifest = json.loads(text)
        except json.JSONDecodeError:
            import yaml
            manifest = yaml.safe_load(text)
        manifest_errors += validate_manifest(manifest)
        if "repro_torch.sweep.job" not in text:
            manifest_errors.append(f"{path}: not the port's job")
    if len(paths) != len(points) or manifest_errors:
        failures.append(f"manifests: {len(paths)} of {len(points)}, "
                        f"{manifest_errors[:3]}")
    log("sweep", collected=len(entries), series=n_series, report_rows=len(rows),
        manifests=len(paths), manifests_valid=not manifest_errors,
        cli_s=f"{t1 - t0:.3f}", points_s=f"{t2 - t1:.3f}",
        records_s=f"{time.perf_counter() - t2:.3f}",
        phase_s=f"{time.perf_counter() - t0:.3f}")
    if failures:
        raise SystemExit("sweep failed: " + "; ".join(failures))


KERNEL_PHASES = ("paged_attention", "moe_gemm", "router", "histogram",
                 "rg_lru", "router_bwd", "rg_lru_bwd", "moe_gemm_bwd")
PHASES = KERNEL_PHASES + ("floor", "main", "gps", "t2e", "resched",
                          "serve_ep", "roofline", "profile", "fleet",
                          "griffin", "reference", "models", "dense", "mla",
                          "rwkv", "seamless", "llava", "sweep", "train")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src/ directory whose repro_torch to run "
                         "(default: this checkout's); another commit's, to "
                         "hold two versions side by side on one card")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} "
                         "(default: all; only a run of all prints the "
                         "kernels line)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(args.src, "repro_torch")):
        print(f"chip_smoke: no repro_torch in {args.src} — run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", nvidia_smi=f"'{smi}'", torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count(),
        tf32="off (cuda.matmul.allow_tf32=False, cudnn.allow_tf32=False)",
        src=os.path.abspath(args.src), phases=",".join(phases))

    t0 = time.perf_counter()
    logs = build.build_all()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        sources=",".join(build.sources()))
    for name, text in logs.items():
        for function, line in ptxas_report(text):
            log("build", kernel=name, function=f"'{function}'",
                ptxas=f"'{line}'")

    from repro_torch.configs.registry import get_config
    mixtral = get_config("mixtral-8x7b")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernel_phases = {
        "paged_attention": lambda: paged_attention_phase(
            flush, args.seed, mixtral.sliding_window),
        "moe_gemm": lambda: moe_gemm_phase(flush, args.seed, mixtral),
        "router": lambda: router_phase(flush, args.seed, mixtral),
        "histogram": lambda: histogram_phase(flush, args.seed),
        "rg_lru": lambda: rg_lru_phase(flush, args.seed),
        "router_bwd": lambda: router_bwd_phase(flush, args.seed, mixtral),
        "rg_lru_bwd": lambda: rg_lru_bwd_phase(flush, args.seed),
        "moe_gemm_bwd": lambda: moe_gemm_bwd_phase(flush, args.seed,
                                                   mixtral)}
    kernels = [kernel_phases[p]() for p in KERNEL_PHASES if p in phases]
    if "floor" in phases:
        launch_floor_phase(flush)
    del flush, kernel_phases
    torch.cuda.empty_cache()

    launches = {}
    if {"main", "gps", "t2e", "resched", "serve_ep"} & set(phases):
        model, cfg = build_mixtral(args.seed)     # one set of weights for all
        if "main" in phases:
            launches.update(main_path_phase(model, cfg, args.seed))
        if "gps" in phases:
            gps_phase(model, cfg, args.seed)
        if "t2e" in phases:
            t2e_phase(model, cfg, args.seed)
        if "resched" in phases:
            resched_phase(model, cfg, args.seed)
        if "serve_ep" in phases:
            serve_ep_phase(model, cfg, args.seed)
        del model
        torch.cuda.empty_cache()
    if "roofline" in phases:
        roofline_phase()
    if "profile" in phases:
        dispatch_profile_phase(args.seed)
    if "fleet" in phases:
        fleet_phase(args.seed)
    if "griffin" in phases:
        launches["rg_lru_scan"] = griffin_phase(args.seed)["rg_lru_scan"]
        griffin_profile_phase(args.seed)
    if "reference" in phases:
        reference_phase(args.seed)
        griffin_reference_phase(args.seed)
    if "models" in phases:
        models_phase(args.seed, smi)
    if "dense" in phases:
        dense_phase(args.seed, smi)
    if "mla" in phases:
        mla_phase(args.seed, smi)
    if "rwkv" in phases:
        rwkv_phase(args.seed, smi)
    if "seamless" in phases:
        seamless_phase(args.seed, smi)
    if "llava" in phases:
        llava_phase(args.seed, smi)
    if "sweep" in phases:
        sweep_phase(args.seed, smi)
    if "train" in phases:
        train_launches = train_phase(args.seed)
        launches.update((k, train_launches[k]) for k in
                        ("fused_topk_route_bwd", "rg_lru_scan_bwd",
                         "moe_gemm_bwd"))

    if set(phases) == set(PHASES):
        for k in kernels:
            k["launches"] = launches[k["name"]]
            if k["name"] == "paged_decode_attention":
                # phase llava's case: its pool shape, its run's launches
                k["cases"] = {"llava_g7_pool": MEASURED["llava_paged_case"]}
        print(json.dumps({"kernels": _measured(kernels)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
