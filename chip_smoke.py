#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (first use builds them) and report the build seconds and the
             card (``nvidia-smi`` name and power limit, also on a line of
             its own);
2. kernel  — each kernel against its plain PyTorch version on the same
             inputs on the card, at the shapes the main path gives it, held
             to max|kernel - plain| / max|plain| <= 2e-5 (CUDA ``sincospif``
             against the host's cos/sin, and FMA contraction over up to 11
             stages); with the kernel's, the plain version's and the
             ``torch.fft`` yardstick's median times and the HBM bound;
             for fft_fused, rfft_fused and irfft_fused (radix 4: the
             register-pass panel) also the passes, shared-memory exchanges
             and barriers per row and the recorded time of the
             stage-at-a-time panel (irfft_fused: with ptxas's registers and
             spills), and for fft2_fused, rfft2_fused and irfft2_fused (the
             same panel over rows and columns) those per frame, the block's
             threads and shared memory, and ptxas's registers and spills;
             fft2_fused also on wide (1024, 64, 256), rfft2_fused on tall
             (1024, 256, 64) frames and irfft2_fused on their half spectra
             (1024, 256, 33), at both radices; for the radix-2 register
             passes (fft_fused, rfft_fused, irfft_fused, fft2_fused,
             rfft2_fused, irfft2_fused) their design line, ptxas's
             registers and spills
             of each instance (0 spilled, or the phase fails) and the
             recorded stage-panel time, and the rows at every n = 2 ... 2^14
             on batches that mask the last row tile;
   kernel  — the same for fft2_columns, the column pass of the composed
             2D route, on the (32, 512, 512) CT frames (its library call
             ``torch.fft.fft(x, dim=-2)``), then on half-spectrum widths
             with a partial last panel, 2048- and 4096-row frames (panels of
             8 and 4 columns) and 8-row frames (one pass), at both radices,
             in place and not; then the composed route itself at the kernel
             entries, fft2, rfft2 and irfft2 on (64, 256, 256),
             (32, 512, 512) and (16, 1024, 1024): one row kernel and one
             fft2_columns launch a call, within 2e-5 of the plain route and
             of ``torch.fft``, its time beside its row and column passes
             alone, the turn route it replaced (rows, a transpose through
             HBM, ``fft_fused`` on the columns as rows, a transpose back;
             each transpose timed alone), ``torch.fft``, the one-trip bound
             and the floor of its two trips;
   kernel  — the same for fft_two_pass, the kernels that fft_fused,
             rfft_fused and irfft_fused launch at radix 2 on rows over one
             block (2^14 < N <= 2^18): fft and ifft on (64, 2^18) complex
             rows, rfft and irfft on (256, 2^16) real rows, against the
             two-pass plain versions to 2e-5 (18 stages), two launches per
             complex call and three per real one; its bound is one HBM
             round trip (the reference's single residency), and each case's
             phase line also gives the floor of this design's two or three
             trips and the time of each pass alone; then every kind at
             N = 2^19 ... 2^24 (2^26 values a case, at both radices:
             both engines run the two passes there), each within 2e-5 of
             its plain version and of ``torch.fft``, beside its one-trip
             bound, its two- or three-trip floor and ``torch.fft``'s time,
             with ptxas's registers and spills of the new instances (0
             spilled the gate); one fft of 129 rows of 2^24 (past 2^31
             values) against ``torch.fft``; and the two passes beside the
             cluster at complex N = 2^15 ... 2^18;
   kernel  — the same for fft_cluster, the kernel those wrappers launch at
             radix 4 on the same rows and on the strip frames' rows
             (rfft and irfft on (4096, 32768), the C 2 instance that
             rfft2/irfft2 reach): one cluster of CTAs a row, holding
             it in distributed shared memory, one HBM round trip and one
             launch per call of every kind, against the cluster plain
             versions to 2e-5; each case's line also gives the instance
             (C CTAs of M values), the clusters the card holds at once
             (``cudaOccupancyMaxActiveClusters``), ptxas's registers and
             spills, and the rate the DSMEM exchange would need if it
             took the whole kernel time;
   kernel  — the same for butterfly_stage on (8192, 2048) planes at every
             stage, flash_attention_fwd at llama3.2-3b's attention shape
             (24 heads of 128, 4096 tokens, causal, k/v repeated from 8 kv
             heads) and mixtral-8x22b's sliding window (4096 of 8192 tokens,
             8 of its 48 heads), both to 2e-5, and slstm_scan at
             xlstm-350m's width (D 1024, 4 heads, batch 8, 4096 steps,
             m0 = -inf) to 1e-4 on hs and the final state, over every
             window of 16 steps from a common state (the recurrence is
             chaotic at the reference's init: two float32 runs part after
             about 100 steps; at steps 32 and 64 of the full run the kernel
             may leave the plain version by at most 4x the plain version's
             own distance from float64), with the time a step, the
             cooperative grid (CTAs, units a CTA, route of wr) and the
             floor of L grid barriers alone on that grid; the saving
             slstm_scan (the instance training runs) at the same width, its
             hs and final state equal to the forward instance's bit for bit
             and its stores (hs, gates, c, n, m) to 1e-4 of the plain
             saving forward over every 16-step window from the state it
             stored before the window; slstm_scan_bwd at the same width, on
             that saving forward of inputs at the model's stacked init
             scale (wr's fan_in 12) with Gaussian cotangents of hs and the
             four final states, to 1e-4 of its plain version
             over every 16-step window from the saved state before it, each
             window's plain version within 1e-4 of float64, the full-length
             launch finite and its last window equal to the window's launch
             bit for bit, timed beside its plain version, its bound, the
             barrier floor and the saving forward, with ptxas's registers
             and spills of each route (none spilled); with the library
             yardstick (``scaled_dot_product_attention``) where one exists. Flash
             attention's products run on the tensor cores as three TF32
             products each, so its bound takes a third of the dense TF32
             rate; each case's line also gives ``simt_bound_ms``, the
             float32 CUDA-core figure, and one line the blocks an SM holds;
3. request — requests through ``repro_torch.xfft`` as the streaming service
             of ``examples/serve_fft2d.py`` answers them (drifting-chirp
             frames plus noise, one request per batch). The launch counts
             are set to 0 just before and read just after; each request
             must raise the counts of the kernels it should use, agree with
             ``torch.fft`` to 2e-5 relative (round trips to 1e-4), and find
             the same dominant bins. Rows over one block: fft/ifft on 64
             free-induction decays of 2^18 points, rfft/irfft on 256 real
             lines of 2^16, rfft2/irfft2 on (8, 512, 32768) strip frames;
             each plans ``fused_r4`` and launches fft_cluster and no
             fft_two_pass; one more ifft on the decays, scoped to
             ``xfft.config(variant="fused")``, launches fft_two_pass and no
             fft_cluster. Past the reference's envelope (2^18 < N <=
             2^24): fft on 4 decays of 2^20 points, rfft on 8 records of
             2^22 samples, fft2 and irfft2 on (2, 8, 2^19) strip frames;
             each plans ``fused_r4`` and launches fft_two_pass (and
             fft2_columns on the frames) and no fft_cluster.
4. imaging — ``repro_torch.core.spectral`` and ``repro_torch.imaging``
             through their public functions at the sizes users send, the
             counts read around each call: registration and apply_shift on
             (512, 128, 128) real and complex frames (planted whole-pixel
             shifts recovered exactly, subpixel ones within 1/10 + 0.05 px
             at ``upsample_factor=10``), correlate2 on the same frames,
             psd_decompose and fft2_psd on (32, 512, 512) CT frames, k-space
             on (8, 4, 256, 256) MRI frames (round trip, Parseval),
             oaconvolve2 on (16, 1024, 1024) holograms with a 31x31 kernel
             and matched_filter2 of a 64x64 template in a 4096x4096 scene
             (the planner's tile; the peak at the planted offset),
             register_logpolar on a 256x256 frame turned a quarter turn,
             fourier_mixing at d_model 512 on (8, 2048, 512) (both
             variants), fftconv on (8, 4096, 768) and stft / log_mel on 8
             clips of 30 s at 16 kHz. Each call is held to a ``torch.fft``
             form of its definition (linear outputs 2e-5, convolutions and
             round trips 1e-4, relative to the largest value), must launch
             the kernels its shapes lead to and run no plain schedule, and
             prints one line: the planner's engine or tile, its median
             CUDA-event time, each kernel launch in it timed alone on the
             same inputs and their sum (``kernel_ms``, ``kernel_share``),
             and the launches, which count toward the ``kernels`` line;
5. mri     — ``repro_torch.mri`` through its public functions, in the
             imaging phase's style, at a clinical 2D multi-coil size: 4
             studies of 16 coils on 256x256 frames, (4, 16, 256, 256) c64
             k-space. sense_forward / sense_adjoint held to a ``torch.fft``
             form of the definition to 2e-5; estimate_sensitivities on a
             seeded variable-density R ~4 acquisition (24 calibration rows),
             held on the object to the definition (1e-4) and to the true
             maps (mean error < 0.06); recon_cg_sense, 10 iterations, on
             the uniform R 4 mask (every study's NRMSE under 0.5 of
             zero-filled, and within 1e-3 of the largest value of a
             float64 ``torch.fft`` CG) and on the variable-density mask with
             the estimated maps (Tikhonov 1e-3: under zero-filled, and
             within 1e-3 of a float64 CG); two shots moved by (3, -2) px:
             moco_forward (2e-5), recon_cg_moco, 8 iterations (under 0.5 of
             motion-blind CG-SENSE), estimate_shot_shifts (within 0.5 px,
             and a recon with the estimate within 1.25x of one with the
             truth). CG lines add the time an iteration, the normal
             operator alone back to back, the CG loop alone around an
             identity operator (its updates and one host sync an
             iteration), and the residual trace. Then
             the double sub-phase under ``xfft.config(precision="double")``:
             the eight transforms at complex128 against ``torch.fft`` in
             float64 to 1e-10 (rows of 1024, the 16-coil stack), SENSE
             adjointness at 16 x 256^2 to 1e-12, every key planned on
             ``reference_x64`` and no single-precision kernel launched.
             Last, ``obs cost``: the k-space frames' fft2 and a cached
             resolve_call with the always-on telemetry installed, dark
             (``xfft.config(flight_recorder=False)``, the reference's
             baseline) and removed, in turns;
6. stream  — the paper's ping-pong processor, ``repro_torch.core.fft2d.
             fft2_stream``, called as its users call it (variant and unroll
             planned: ``fused_r4`` on the card): examples/serve_fft2d.py's 8
             requests of 8 real 128x128 camera frames (each within 2e-5 of
             ``torch.fft.fft2``, the same dominant bins), 64 CT slices of
             512x512, 16 holograms of 1024x1024 and 16 time steps of 16
             coils at 256x256 (c64). Each call must launch ceil(T/u)
             ``fft_fused`` on one CUDA stream and as many ``fft2_columns``
             on another, neither the caller's. One line a shape: the plan,
             the error against ``torch.fft.fft2`` and against the plain
             stream on the card (2e-5), and at unroll 1 and 2 the eager
             two-stream call's time, the same steps on one stream, the
             call captured in a CUDA graph and replayed (equal to the eager
             call, bit for bit) and the one-stream steps replayed so, the
             host's time to enqueue a call, and
             frames/s (``benchmarks/throughput.py``'s metric); beside them
             the batched route over all T frames at once
             (``ops.fft2_kernel``), ``torch.fft.fft2`` and the two-trip
             floor. Then the double stream on (8, 256, 256) under
             ``xfft.config(precision="double")``: ``reference_x64``,
             complex128, 1e-10, no kernel launched;
7. serve   — ``repro_torch.serve`` as its users call it, one line a call:
             ``SpectrumService`` on 256 interleaved real and complex
             128x128 frames under ``BatchPolicy(max_batch=16)``, call-scoped
             (``serve()`` on arrival-order chunks of 16) and streaming
             (``loop.submit`` and ``drain``): dispatches, requests/s, p50/p99
             of the lanes' ``LatencyHistogram`` beside the raw samples' p99
             (within one bucket), the loop dispatching no more batches than
             the call-scoped run; where a 128x128 lane's host time goes
             (stack, plan, the engine's op, the wait) beside the op's and
             the kernel's card time; a lane of 32 complex 512x512 CT frames
             and one of 16 real 1024x1024 holograms (the composed route);
             one ``ImagingService`` queue of registrations (256x256, upsample
             1 and 10), "same" convolutions of 1024x1024 holograms with
             31x31 kernels, CG-SENSE recons of (16, 256, 256) k-space with
             the mask on the card, and 128x128 spectra, each lane's result
             within 2e-5 of the direct call on the same stacked batch; a
             started loop fed by 4 threads, its tickets checked, ``stop()``
             draining, the loop thread's events held to no degrade from
             the flight recorder; ``pretune`` into a fresh cache, ``export``,
             ``warm_start`` and a MEASURE-mode service on the covered shapes
             (no ``plan.measure`` span, every ``plan.resolve`` a hit,
             ``xfft.report`` rendered). Spectra within 2e-5 of
             ``torch.fft``; per lane the kernels launched. Its services'
             launches count toward the ``kernels`` line;
7b. pencil — the multi-device 2D FFT, ``repro_torch.core.distributed``:
             one rank on an ``nccl`` group (a ``FileStore`` in a temporary
             directory, ``make_mesh((1,), ("data",))``, destroyed after) on
             4 real 4096x4096 holograms and one real 8192x8192 frame (its
             columns take the turn route): ``fft2_pencil`` and
             ``fft2_pencil_overlapped`` under the plan's variant and
             chunks, the overlapped one also at chunks 4. One line a call:
             the error against ``torch.fft.fft2`` and against the same call
             under the plain schedules on the card (2e-5), CUDA-event ms
             beside ``xfft.fft2`` (the composed route) and ``torch.fft.fft2``
             on the same frames and the HBM floor of the call's round
             trips; the ``fft_fused`` and ``fft2_columns`` launches, the
             ``all_to_all_single`` calls (must equal chunks) and the gathers
             (1 overlapped, 0 plain). Then gloo groups of 2 and 4 ranks
             sharing the card (NCCL takes one rank a card), each rank a
             process of its own (``--pencil-rank``, a deadline each) on a
             4096x4096 frame sharded by rows, its passes on the card's
             kernels: the gathered result within 2e-5 of ``torch.fft.fft2``
             here; host ms a call, gloo's, which stages the exchange
             through the host. The NCCL calls' launches count toward the
             ``kernels`` line;
7c. lm    — repro_torch's LM serving at llama3.2-3b's full width (28
             layers, d_model 3072, vocab 128256, bf16 compute over 12.85 GB
             of float32 weights from a seeded generator on the card):
             ``ServeEngine.serve_queue`` on the launcher's default queue
             (8 requests of 16 tokens, batch 4, 16 new) and one lane of 4
             prompts of 1024 tokens, the counts set to 0 just before and
             read just after: ``flash_attention_fwd`` 28 times a lane
             batch's prefill, never on a decode step, no other kernel;
             the kernel against its plain version at the lanes' shapes
             ((96, 16, 128) and (96, 1024, 128), the config's blocks, q
             scaled first as the route calls it) to 2e-5 on Gaussian
             operands, and on the model's own layer-0 operands against
             float64 (within 4x the plain version's distance); the same
             queues served again (the same tokens), timed: tokens/s,
             prefill ms a lane batch, decode ms a step, the kernel's share
             of the prefill, the weights' cast; decode after a prefill of
             s tokens against the prefill of s + 1 at float32 (2e-3) and
             at bf16 (within 2x the gap of the reference's own function as
             the prefill attention, under 0.5), the first served token the
             prefill's argmax; a 2-layer full-width float32 copy card
             against CPU (logits 1e-3, tokens equal wherever the CPU's
             top-2 margin exceeds that). Its launches count toward the
             ``kernels`` line;
7d. lm state — the same for the recurrent-state families, one after the
             other, each at full width with bf16 compute over float32
             weights from a seeded card generator (after the lm phase's
             llama weights are freed): xlstm-350m (24 layers of mLSTM /
             sLSTM, d_model 1024, vocab 50304), whose every sLSTM prefill
             launches ``slstm_scan`` (12 a lane batch at (4, S, 4096)), and
             zamba2-2.7b (54 Mamba2 layers, d_model 2560, vocab 32000, one
             shared attention block of 32 heads of 160 every 6 layers),
             whose shared block's prefill launches ``flash_attention_fwd``
             (9 a lane batch at (128, S, 160)); neither on a decode step,
             no other kernel. The kernel on the model's own operands at
             each lane's shape: ``slstm_scan`` on layer 0's ``xg`` against
             its plain version over every 16-step window from a common
             state (1e-4), ``flash_attention_fwd`` on Gaussian operands
             (2e-5) and on the first invocation's own q, k, v against
             float64; each timed beside its plain version (and SDPA) and
             its bound. The timed serve (tokens/s, prefill ms a lane
             batch, decode ms a step, the kernel's share of the prefill,
             peak memory); decode against the prefill of s + 1 at full
             depth, bf16 and float32, beside the reference's route for the
             kernel (the plain step loop or ``flash_attention_blocks``),
             printed and held finite with the first token the prefill's
             argmax (these models amplify a rounding to O(0.1-1) over
             their depth at this init), and at the cut depth below at
             float32 within 2e-3; a copy cut in depth
             (one mLSTM / sLSTM pair; one group of 2 Mamba2 layers and
             the shared block after it) card against CPU at float32
             (1e-3, tokens equal wherever the CPU's top-2 margin exceeds
             that). Its
             launches count toward the ``kernels`` line;
7e. lm audio — whisper-medium at full width (24 encoder and 24 decoder
             layers, d_model 1024, 16 heads of 64, vocab 51865; 0.811 B
             parameters, bf16 compute over float32 weights) through
             ``ServeEngine`` on two queues of 8 requests at batch 4 (16- and
             128-token prompts, 16 new), every lane batch carrying
             ``frames_for``'s (4, 1500, 1024) frames: ``flash_attention_fwd``
             72 times a prefill (encoder, decoder self- and
             cross-attention) and 24 a decode step (cross-attention), no
             other kernel; the kernel on the model's own operands at
             (64, 1500, 64) non-causal, (64, S, 64) causal, (64, S→1500, 64)
             and (64, 1→1500, 64), each against its plain version (2e-5 on
             Gaussian operands, float64 on the model's), timed beside it,
             SDPA and its bound; the timed serve (tokens/s, prefill ms,
             decode ms a step, the kernel's share of each); decode against
             the prefill of s + 1 at full depth printed beside the plain
             attention route's gap, gated at float32 (2e-3) on one encoder
             and one decoder layer; that copy card against CPU (decode
             logits 1e-3, tokens, the forward within 2x of the plain route's
             distance from the CPU: see AUDIO_QUEUES);
7f. lm spectral — fourier_lm at full width (12 FNet blocks, d_model 512,
             vocab 32768) on ``make_batch``'s MLM batch of (8, 2048) under
             ``torch.no_grad()``: ``loss_fn`` and ``prefill_fn`` each
             launch, per block, the kernels of one planned fft2 of (8,
             2048, 512) as the census gives them (the composed route: one
             ``fft_fused`` and one ``fft2_columns``), nothing else; the
             forward again with every launch recorded, held against its
             plain twin (2e-5) and timed alone: forward ms, tokens/s, the
             kernels' and the mixing calls' share; card against CPU at
             float32, full depth, 2 sequences (logits and loss, 1e-3).
             Its launches count toward the ``kernels`` line;
7g. lm moe — the moe family at full width, cut in depth (see MOE_ARCHS):
             mixtral-8x22b (2 layers, a window of 4096, 8 experts top-2)
             on the launcher's queue and 2 x 8192 tokens past its window,
             then deepseek-v3-671b (1 dense + 1 moe MLA layer, 256 bf16
             routed experts top-8 and one shared, the MTP head) on the
             launcher's queue and 4 x 1024, and its ``loss_fn`` on (2,
             1024): ``flash_attention_fwd`` once a layer a prefill (the
             MTP block once more), never on a decode step, no other
             kernel; the kernel at each lane's shape (Gaussian operands
             2e-5, layer 0's own against float64); the timed serve
             (tokens/s, prefill and decode ms, the kernel's and the moe
             block's share, peak memory, the share of assignments the
             prefills dropped at capacity factor 1.25); decode against
             the prefill of s + 1 (bf16 printed; float32 with nothing
             dropped, 2e-3); a depth-cut copy (deepseek's also cut to 32
             routed experts) card against CPU at float32 (1e-3, tokens,
             expert ids). Its launches count toward the ``kernels`` line;
7h. lm train — training on the card: ``flash_attention_bwd`` (the
             backward of the model's attention, a kernel with no TPU
             counterpart) at llama3.2-3b's training lane (48, 1024, 128)
             causal, with the forward's logsumexp, against its plain version
             (2e-5) and float64 autograd of ``mha_reference`` (Gaussian
             operands and the model's own layer-0 q, k, v), and at a window,
             cross-attention (64, 128->1500, 64), MLA's 192 -> 128 and Dv 160;
             each timed beside its plain version, SDPA's backward and its
             bound (the forward's yardstick: a third of the dense TF32 rate,
             the CUDA-core float32 figure beside it as ``simt_bound_ms``),
             and the forward with and without the logsumexp; the kernel's
             row also gives ptxas's registers and spills of each pass at
             each width instance (none spilled at widths 32 to 128). Then
             llama3.2-3b (2 x 1024, remat), fourier_lm (8 x 2048) and
             xlstm-350m (4 x 4096, remat) train 3 steps each at full width
             through ``repro_torch.launch.train``'s entry without
             checkpoints, the counts set to 0 just before and read just
             after: llama 56 ``flash_attention_fwd`` (forward and
             recompute) and 28 ``flash_attention_bwd`` a step, fourier_lm 36
             ``fft_fused`` and 36 ``fft2_columns`` (forward, recompute, and
             the mixing's backward on the same planned kernels), xlstm 24
             ``slstm_scan`` (forward and recompute) and 12
             ``slstm_scan_bwd`` a step, nothing else; step ms, tokens/s,
             the kernels' share estimated from their launches and their
             times alone (the backward kernels alone too; xlstm's from the
             saving slstm_scan and slstm_scan_bwd checked as in the kernel
             phase at its training shape, 4 x 4096), peak memory
             (under 85 GB). Card and CPU gradients at float32 (llama's
             first 2 layers of its full-width init on 2 x 256, fourier_lm
             at full depth on 2 x 2048, xlstm's first mLSTM / sLSTM pair on
             2 x 64), each held against the same model in float64 on the
             CPU (see TRAIN_GRAD_CEILING), with its launches, and the llama
             copy overfitting one batch. Its launches count toward the
             ``kernels`` line;
7i. dryrun — after lm dist: ``repro_torch.launch.dryrun`` counts
             llama3.2-3b's training lane (2 x 1024) on meta tensors on a
             one-card (1x1) mesh, then the same step runs on the card
             under the same ``CostCounter``, the counts set to 0 just
             before: its argument bytes must equal the bytes of the live
             TrainState and batch, the flops on meta the flops on the card
             exactly (kernel charges included), the card's peak
             (``max_memory_allocated``) within DRYRUN_PEAK_BAND of the
             predicted argument + temp bytes; the roofline step ms (H100
             data-sheet rates) beside the measured step ms. Its launches
             count toward the ``kernels`` line;
   After each of the kernel, request, imaging, mri, stream, serve, pencil,
   lm, lm state, lm audio, lm spectral, lm moe and lm train phases (one
   ``obs.capture()`` around the thirteen) a
   ``"check": "no degrade"`` line: no ``resilience.failover``, ``resilience.fault`` or
   ``plan.degrade`` event, no MEASURE candidate skipped, and
   ``kernel.failover`` (the composed 2D route) only on frames over the
   shared-memory census. Then ``"call": "fault"``: a ``serve.batch``
   fault firing once is retried once and the lanes are right; a
   ``max_queue`` under the call's depth sheds it with ``Overloaded``
   before any lane runs (outside the capture);
8. resilience — faults injected through ``xfft.config(faults=...)``, one
             line a check, the breaker on an injected clock: an
             ``engine.apply`` error on ``fused_r4`` for fft2 and rfft2 on
             (512, 128, 128) and fft on (64, 2^18) fails over to ``fused``
             (radix-2 ``fft2_fused`` / ``rfft2_fused``, the two-pass
             kernels), within 2e-5 of ``torch.fft``, opens the breaker, the
             next call resolves ``quarantined`` while the cache keeps
             ``fused_r4``, and after the cooldown a half-open probe runs
             ``fused_r4`` (radix 4, the cluster kernel) and closes it; an
             error on every engine raises the last ``InjectedFault`` with
             no plain schedule run; a ``nan`` fault under
             ``check_health="nan"`` fails over to a finite output, with the
             guard's host µs a call; a ``vmem`` fault at ``kernel.fused``
             runs fft2, rfft2 and irfft2 of (512, 128, 128) on the
             composed route (the row kernel and fft2_columns, one launch
             each), within 2e-5, timed against one block; MEASURE (``plan_fft(mode="measure")``) on
             the request keys in both directions, each candidate's median
             µs (CUDA events) beside ESTIMATE's pick, the wisdom file
             loaded by a second process that must hit every key and time
             nothing, a double key timing ``reference_x64`` alone, and a
             ``torch.cuda.graph`` capture that degrades
             (``trace_not_clean``), an fft2 of (512, 128, 128) captured in
             a graph under ``check_health="nan"`` (the guard reads nothing
             there: no failover; the replay within 2e-5); last the ladder's host µs a call: the
             front door, ``run_plan`` with and without the telemetry sinks,
             and the planned engine's op alone, on a (256, 256) fft2 and
             the (4, 16, 256, 256) k-space frames. Its launches do not
             count toward the ``kernels`` line;
9. path    — the other entry points of ``repro_torch.kernels``, with the
             counts set to 0 just before and read just after:
             ``fft_staged`` on (8192, 2048) must launch ``butterfly_stage``
             exactly 11 times and agree with ``torch.fft`` to 2e-5;
             ``flash_attention_fwd`` on the llama shape must launch once and
             agree with ``mha_reference`` to 2e-5; ``slstm_scan`` on
             ``xg = x @ wx``, with weights carried across by
             ``slstm_weights_from_jax`` from seeded numpy, must launch once
             and repeat the kernel phase's result. Then the staged against
             the fused FFT's time, beside ``hbm_traffic_model``'s ratio.

Then one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0 and the last line is not printed. Without CUDA the script
exits 2 and prints no result.

    python3 chip_smoke.py --slstm-ab OTHER_ROOT [--backward]

times ``slstm_scan`` at xlstm-350m from another checkout's ``src`` and from
this one, one process each, in turns (other, this, this, other), and says
whether their outputs agree bit for bit (sha256 of hs and the final state);
with ``--backward``, ``slstm_scan_bwd`` (dxg and the initial states'
gradients) at the model's init scale.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL_KERNEL = 2e-5
TOL_REQUEST = 2e-5
TOL_ROUND_TRIP = 1e-4
TOL_SLSTM = 1e-4
SLSTM_WINDOW = 16  # steps from a common state over which slstm_scan is held
# Steps of the full-length slstm_scan launch at which the kernel's distance
# from the plain version is held to this factor times the plain version's
# distance from float64 (both still small there; later the two float32 runs
# part at O(1), whatever the kernel).
SLSTM_DIVERGENCE_STEPS = (32, 64)
SLSTM_DIVERGENCE_FACTOR = 4.0

PEAK_FLOPS_FP32 = 67e12  # H100 SXM data sheet, float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def hbm_bandwidth(card: str) -> float:
    """Bytes/s of the card's HBM: H100 SXM 3.35 TB/s, H100 PCIe 2.0 TB/s
    (NVIDIA data sheets)."""
    return 2.0e12 if "PCIe" in card else 3.35e12


def split_tf32_rate(card: str) -> float:
    """Float32-accurate products per second on the tensor cores: a third of
    the dense TF32 rate, each float32 product taken as three TF32 products
    (H100 SXM 495 TFLOP/s, H100 PCIe 378 TFLOP/s dense TF32; NVIDIA data
    sheets)."""
    return (378e12 if "PCIe" in card else 495e12) / 3


def rel_err(got, ref) -> float:
    import torch

    got = got.to(torch.complex128) if got.is_complex() else got.double()
    ref = ref.to(torch.complex128) if ref.is_complex() else ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def max_abs(got, ref) -> float:
    return float((got - ref).abs().max())


def time_ms(fn, reps: int = 10, batches: int = 5) -> float:
    """Median over ``batches`` of the CUDA-event time of ``reps`` calls,
    per call (the calls queue back to back, so the card stays busy)."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def enqueue_ms(torch, fn, reps: int = 20) -> float:
    """Host wall time a call of ``fn`` takes to return (its launches
    enqueued, not waited for), over ``reps`` calls after a warmup."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def frame_source(step: int, batch: int, h: int, w: int, seed: int = 0):
    """The synthetic camera of examples/serve_fft2d.py: a drifting 2-D chirp
    plus noise, frame shape (h, w)."""
    import numpy as np

    rng = np.random.default_rng(seed ^ step)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    base = np.sin(2 * np.pi * (3 + step % 5) * xx) * np.cos(2 * np.pi * 2 * yy)
    noise = rng.standard_normal((batch, h, w)).astype(np.float32) * 0.1
    return base[None] + noise


def peaks(spec, full: bool = True):
    """Dominant non-DC bin of each frame (the service's detection).

    A real frame's full spectrum is Hermitian: bin (ky, kx) and its mirror
    (-ky, -kx) have the same magnitude, so argmax picks between the two on
    rounding alone. A full spectrum's peak is reported as the smaller flat
    index of the pair. A half spectrum (rfft2) holds such pairs only in its
    first and last columns, where the chirp frames have no peak.
    """
    h, w = spec.shape[-2], spec.shape[-1]
    mags = spec.abs().reshape(spec.shape[0], -1).clone()
    mags[:, 0] = 0
    p = mags.argmax(dim=1)
    if not full:
        return p
    mirror = ((-(p // w)) % h) * w + (-(p % w)) % w
    return p.minimum(mirror)


KERNELS = {
    "fft_fused": ("src/repro_torch/kernels/csrc/fft_fused.cu",
                  "src/repro/kernels/fft_radix2.py:279"),
    "rfft_fused": ("src/repro_torch/kernels/csrc/fft_fused.cu",
                   "src/repro/kernels/fft_radix2.py:319"),
    "irfft_fused": ("src/repro_torch/kernels/csrc/fft_fused.cu",
                    "src/repro/kernels/fft_radix2.py:358"),
    "fft2_fused": ("src/repro_torch/kernels/csrc/fft2_fused.cu",
                   "src/repro/kernels/fft_radix2.py:411"),
    "rfft2_fused": ("src/repro_torch/kernels/csrc/rfft2_fused.cu",
                    "src/repro/kernels/fft_radix2.py:452"),
    "irfft2_fused": ("src/repro_torch/kernels/csrc/rfft2_fused.cu",
                     "src/repro/kernels/fft_radix2.py:486"),
    "fft_two_pass": ("src/repro_torch/kernels/csrc/fft_two_pass.cu",
                     "src/repro/kernels/fft_radix2.py:279"),
    "fft_cluster": ("src/repro_torch/kernels/csrc/fft_cluster.cu",
                    "src/repro/kernels/fft_radix2.py:279"),
    "fft2_columns": ("src/repro_torch/kernels/csrc/fft2_columns.cu",
                     "src/repro/kernels/ops.py:177"),
    "butterfly_stage": ("src/repro_torch/kernels/csrc/butterfly.cu",
                        "src/repro/kernels/butterfly.py:64"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:81"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "none: the reference differentiates "
                            "src/repro/models/attention.py:29 by XLA"),
    "slstm_scan": ("src/repro_torch/kernels/csrc/slstm_scan.cu",
                   "src/repro/kernels/slstm_scan.py:86"),
    "slstm_scan_bwd": ("src/repro_torch/kernels/csrc/slstm_scan_bwd.cu",
                       "none: the reference differentiates its lax.scan over _slstm_step "
                       "(src/repro/models/xlstm.py:272) by XLA"),
}

# llama3.2-3b attention (src/repro/configs/llama3_2_3b.py): 24 query heads
# of 3072/24 = 128, 8 kv heads, one sequence of 4096 tokens, causal.
LLAMA = {"heads": 24, "kv_heads": 8, "seq": 4096, "head_dim": 128}
# mixtral-8x22b (src/repro/configs/mixtral_8x22b.py): head 6144/48 = 128,
# sliding window 4096; 8 of the 48 heads, 8192 tokens, causal.
MIXTRAL = {"heads": 8, "seq": 8192, "head_dim": 128, "window": 4096}
# xlstm-350m (src/repro/configs/xlstm_350m.py): D 1024, 4 sLSTM heads.
XLSTM = {"batch": 8, "seq": 4096, "d": 1024}
# xlstm-350m's init draws its stacked sLSTM weights (12 pairs, 4, 256,
# 1024) with fan_in = shape[0] = 12 (models/param.py), so wr's std is
# 0.5 / sqrt(12); slstm_scan's kernel check takes one layer's skeleton
# alone (fan_in 4: std 0.25), where the recurrence is chaotic and the
# backward's cotangents grow without bound over L steps. The backward's
# check takes the scale the model trains from.
XLSTM_TRAIN_FAN_IN = 12
STAGED = (8192, 2048)
# The radix-4 times with the stage-at-a-time panel the kernels ran before
# the register passes, as PERF.md §6 records them (NVIDIA H100 80GB HBM3,
# 700.00 W): fft_fused and rfft_fused on (8192, 2048), irfft_fused on
# (8192, 1025), fft2_fused and rfft2_fused on (512, 128, 128), irfft2_fused
# on (512, 128, 65); printed beside this run's.
STAGE_PANEL_R4_MS = {"fft_fused": 0.1905, "rfft_fused": 0.1118, "irfft_fused": 0.1056,
                     "fft2_fused": 0.1313, "rfft2_fused": 0.0725, "irfft2_fused": 0.0776}
# The same for the radix-2 fft_fused and rfft_fused on (8192, 2048) and
# irfft_fused on (8192, 1025), which ran the stage-at-a-time panel until
# their register passes, as PERF.md §6 records them (NVIDIA H100 80GB HBM3,
# 700.00 W).
STAGE_PANEL_R2_MS = {"fft_fused": 0.3892, "rfft_fused": 0.2101, "irfft_fused": 0.2049}
# The radix-2 fft2_fused on (512, 128, 128) and FRAME_WIDE, rfft2_fused on
# (512, 128, 128) and FRAME_TALL, irfft2_fused on their half spectra,
# fft2_columns on CT, and fft_two_pass's kinds on TWO_PASS_COMPLEX and
# TWO_PASS_REAL, with the stage-at-a-time panel they ran before their
# register passes, as PERF.md §6 records them (NVIDIA H100 80GB HBM3,
# 700.00 W).
STAGE_PANEL_FRAME_R2_MS = {("fft2_fused", (512, 128, 128)): 0.2108,
                           ("fft2_fused", (1024, 64, 256)): 0.4281,
                           ("rfft2_fused", (512, 128, 128)): 0.1041,
                           ("rfft2_fused", (1024, 256, 64)): 0.2060,
                           ("irfft2_fused", (512, 128, 65)): 0.1054,
                           ("irfft2_fused", (1024, 256, 33)): 0.2064,
                           ("fft2_columns", (32, 512, 512)): 0.1316}
STAGE_PANEL_TWO_PASS_MS = {"fft": 0.5579, "ifft": 0.5574, "rfft": 0.2898, "irfft": 0.2883}
# The register-pass instances of the row kernels in the build log, one a
# line length and radix: (log2 n, radix) and (log2 m, radix).
ROW_PASS_ENTRIES = {"fft_fused": "15fft_regs_kernel", "rfft_fused": "16rfft_regs_kernel",
                    "irfft_fused": "17irfft_regs_kernel"}
# The two passes' instances, (log2 n1, log2 C) and (log2 n2, log2 T).
TWO_PASS_ENTRIES = {"columns": "23two_pass_columns_kernel", "rows": "20two_pass_rows_kernel"}
# Non-square frames of the whole-frame kernels: wide complex frames
# (line-scan tiles) and tall real ones.
FRAME_WIDE = (1024, 64, 256)
FRAME_TALL = (1024, 256, 64)
# The register-pass instances of the whole-frame kernels in the build log:
# (log2 H, log2 W, radix) of fft2_fused, (log2 H, log2 m, radix) of
# rfft2_fused and irfft2_fused ((0, 0, radix) the runtime geometry).
FRAME_REGS_ENTRIES = {"fft2_fused": "16fft2_regs_kernel", "rfft2_fused": "17rfft2_regs_kernel",
                      "irfft2_fused": "18irfft2_regs_kernel"}
FRAME_R2_KERNELS = ("fft2_fused", "rfft2_fused", "irfft2_fused")
# The radix-2 irfft2_fused's instances: the runtime geometry (the tall
# frame's), the 128x128 frame, and each frame of 16384 values (1024 threads).
IRFFT2_R2_INSTANCES = sorted({(0, 0), (7, 6)} | {(a, 14 - a) for a in range(1, 15)})
# fft2_columns's instances, one a radix (the panel's geometry at run time).
COLUMNS_ENTRY = "24fft2_columns_regs_kernel"
# Rows over one block: FT-NMR free-induction decays of 256K complex points,
# and 64K-sample real lines (radar range lines, spectroscopy).
TWO_PASS_COMPLEX = (64, 2 ** 18)
TWO_PASS_REAL = (256, 2 ** 16)
# Rows past the reference's fused envelope, 2^19 ... 2^24 (2^24 complex
# values: 134 ms of a 125 MHz radio channel, a 16 M-point FID), on the two
# passes at both radices: 2^26 values a case, (4, 2^24) the largest. One
# complex case past 2^31 values (129 rows of 2^24, 17.3 GB a tensor) holds
# the 64-bit row bases.
LONG_ROWS = tuple(2 ** p for p in range(19, 25))
LONG_ROW_VALUES = 2 ** 26
LONG_PAST_2_31 = (129, 2 ** 24)
# The instances the long rows add: (log2 n1, log2 C) and (log2 n2, log2 T).
LONG_ROW_INSTANCES = {"columns": [(10, 4), (11, 3), (12, 2)],
                      "rows": [(10, 4), (11, 3), (12, 2)]}
# Requests past 2^18 through xfft: 1 M-point FIDs, 4 M-sample seismic
# records (2^22 at 100 Hz is 11.6 h), 2^19-wide strip frames.
LONG_FID = (4, 2 ** 20)
LONG_RECORDS = (8, 2 ** 22)
LONG_STRIP = (2, 8, 2 ** 19)
STRIP = (8, 512, 32768)  # line-scan / SAR strip frames, 32768 samples wide
# The spectral and imaging phase, at the sizes users send: registration on
# 128x128 serving frames, psd on 512x512 CT frames, k-space on 256x256 MRI
# frames (8 coils x 4 slices), overlap-save on 1024x1024 holograms with a
# 31x31 kernel, a 64x64 template in a 4096x4096 scene, fourier_lm's mixing
# width (d_model 512, src/repro/configs/fourier_lm.py) over 2048 tokens,
# fftconv on 4096 steps of 768 channels, and 30 s clips at 16 kHz.
REG = (512, 128, 128)
CT = (32, 512, 512)
MRI = (8, 4, 256, 256)
HOLO, HOLO_KERNEL = (16, 1024, 1024), 31
SCENE, TEMPLATE = 4096, 64
MIX = (8, 2048, 512)
CONV = (8, 4096, 768)
AUDIO = (8, 30 * 16000)
LOGPOLAR = 256
UPSAMPLE = 10
# The mri phase: a clinical 2D multi-coil acquisition, 256x256 (fastMRI
# brain data has 16-20 coils on a 320x320 crop; the port plans powers of
# two), 16 receive coils, a batch of 4 studies: (4, 16, 256, 256) c64
# k-space, 33.5 MB. Uniform R 4 with 24 calibration rows and a seeded
# variable-density R ~4 mask; 10 CG iterations; 2 shots moved by (0, 0)
# and (3, -2) px, 8 motion-compensated iterations. The double sub-phase:
# rows of 1024 and the 16-coil 256x256 stack at complex128.
RECON = (4, 16, 256, 256)
ACCEL, CALIB = 4, 24
CG_ITERS, MOCO_ITERS = 10, 8
MOCO_SHIFTS = ((0.0, 0.0), (3.0, -2.0))
X64_ROWS = (64, 1024)
TOL_CG_F64 = 1e-3     # float32 CG against float64 over 10 iterations
TOL_X64 = 1e-10       # the reference's double gate (benchmarks/accuracy.py)
TOL_ADJOINT_X64 = 1e-12
OBS_GATE_PCT = 3.0     # the reference's telemetry overhead gate (benchmarks/obs_bench.py)
# The resilience phase: MEASURE on the request phase's keys, both
# directions (kind, shape, dtype), and a double key on reference_x64.
MEASURE_KEYS = (("fft2d", REG, "complex64"), ("fft2d", CT, "complex64"),
                ("fft2d", (16, 1024, 1024), "complex64"), ("rfft2d", REG, "float32"),
                ("rfft2d", CT, "float32"), ("rfft2d", (16, 1024, 1024), "float32"),
                ("fft1d", STAGED, "complex64"), ("fft1d", TWO_PASS_COMPLEX, "complex64"),
                ("rfft1d", TWO_PASS_REAL, "float32"))
MEASURE_X64_KEY = ("fft2d", (16, 256, 256), "complex64")
# The stream phase: the paper's ping-pong processor (fft2_stream) at the
# sizes its users send: examples/serve_fft2d.py's requests (8 requests of 8
# real 128x128 camera frames), 64 CT slices of 512x512, 16 holograms of
# 1024x1024, 16 time steps of 16 coils at 256x256, and the double stream on
# (8, 256, 256); each timed at unroll 1 and 2. Its two engines' kernels.
STREAM_SERVE = (8, 8, 128, 128)  # requests, frames a request, H, W
STREAM_SHAPES = ((64, 512, 512), (16, 1024, 1024), (16, 16, 256, 256))
STREAM_X64 = (8, 256, 256)
STREAM_UNROLLS = (1, 2)
STREAM_KERNELS = ("fft_fused", "fft2_columns")
# The serve phase (repro_torch.serve) at the sizes of PERF.md §1 and the
# traffic of benchmarks/serve_bench.py and examples/serve_loop.py: 256
# interleaved real and complex 128x128 frames (serve_bench's two-lane worst
# case) under max_batch 16, call-scoped and streaming; a lane of 32 complex
# 512x512 CT slices and one of 16 real 1024x1024 holograms (the composed
# route); one mixed ImagingService queue: 8 registration pairs of 256x256 at
# upsample 1 and 8 at 10, 4 "same" convolutions of 1024x1024 holograms with
# 31x31 kernels, 4 recon requests of (16, 256, 256) k-space at R 4 with 10
# CG iterations and the mask on the card, 16 spectra of 128x128; a started
# loop at max_batch 8 and a 2 ms window fed by 4 threads of 32 mixed
# 128x128 frames; wisdom pretuned at 128, 256 and 512. The kernels the
# phase must launch.
# The pencil phase (PR 29): one NCCL rank on 4 holograms of 4096x4096
# (512 MiB complex) and one 8192x8192 frame (512 MiB; holography and
# astronomy sizes), the overlapped variant also at 4 slabs; gloo groups of
# 2 and 4 ranks on one 4096x4096 frame, each rank given a deadline.
PENCIL_FRAMES = ((4, 4096, 4096), (8192, 8192))
PENCIL_CHUNKS = 4
PENCIL_GROUP = (4096, 4096)
PENCIL_WORLDS = (2, 4)
PENCIL_GROUP_CHUNKS = 2
PENCIL_KERNELS = ("fft_fused", "fft2_columns")
PENCIL_DEADLINE_S = 300.0
# The lm phase (PR 30): repro_torch's LM serving at llama3.2-3b's full
# width (28 layers, d_model 3072, 24 heads of 128, 8 kv heads, vocab
# 128256, bf16 compute over float32 weights; 3.21 B parameters, random
# from a seeded generator on the card). Two queues through
# ServeEngine.serve_queue: the launcher's default (8 requests of 16-token
# prompts, batch 4, max_new 16, max_len 128) and one lane of 4 prompts of
# 1024 tokens (max_len 2048): (label, requests, prompt length, batch,
# max_new, max_len).
LM_ARCH = "llama3.2-3b"
LM_QUEUES = (("launcher", 8, 16, 4, 16, 128), ("long prompts", 4, 1024, 4, 16, 2048))
# Card against CPU: a copy of the config cut to 2 layers at full width, at
# float32 compute, the same weights on both; logits within 1e-3 of the
# CPU's largest, greedy tokens (LM_CHECK_NEW a request) equal wherever the
# CPU's top-2 margin exceeds that.
LM_CHECK_LAYERS = 2
LM_CHECK_NEW = 8
TOL_LM_CPU = 1e-3
# The card against itself (tests/models/test_arch_smoke.py's golden test):
# decode logits after a prefill of s tokens against the prefill of s + 1.
# At float32 compute (the same weights) within the reference test's 2e-3
# of the largest logit. At bf16 the two routes round differently (2^-8)
# through 28 layers, and at the reference's init the scores are ~1e2, so
# the gap grows layer by layer even for the reference's own function: the
# port's gap is held to LM_BF16_FACTOR times that of the reference's
# function (``flash_attention_blocks``) run as the prefill attention on
# the same card tensors, and under LM_BF16_CEILING (a route that read a
# wrong slot or position gives logits unrelated to the prefill's, off by
# ~1 of the largest).
TOL_LM_F32_GOLDEN = 2e-3
LM_BF16_FACTOR = 2.0
LM_BF16_CEILING = 0.5
# The kernel on the model's own layer-0 operands, where the softmax is
# nearly one-hot and rounding of a score moves the output: its distance
# from float64 at most this factor times the plain version's (or 2e-5).
LM_FLOAT64_FACTOR = 4.0
# The recurrent-state lm phase: xlstm-350m (24 layers of
# alternating mLSTM / sLSTM, d_model 1024, 4 heads, vocab 50304; 0.427 B
# parameters) and zamba2-2.7b (54 Mamba2 layers, d_model 2560, one shared
# attention block of 32 heads of 160 re-invoked every 6 layers, vocab
# 32000; 2.59 B), each at full width, bf16 compute over float32 weights
# random from a seeded card generator, served on LM_QUEUES in turn and
# held as the lm phase holds llama3.2-3b. (arch, the kernel its prefill
# launches, launches a prefill, layers of the copy cut in depth: one
# mLSTM / sLSTM pair; one group of 2 Mamba2 layers, which the shared block
# follows as it follows every group.)
LM_STATE_ARCHS = (("xlstm-350m", "slstm_scan", 12, 2),
                  ("zamba2-2.7b", "flash_attention_fwd", 9, 2))
# At their random init these models amplify a rounding: a relative change
# of 1e-7 in the embeddings moves the float32 last logits by this much of
# the largest (tools/lm_sensitivity.py, CPU): xlstm-350m 2.9e-5 at one
# pair, 2.5e-2 at 24 layers; zamba2-2.7b 6.4e-6 at 2 layers, 1.3e-3 at 6
# (each Mamba2 layer replaces x, no residual), O(1) at 54. So the gates of
# 1e-3 (card against CPU) and 2e-3 (decode against prefill) hold at those
# cut depths only; at full depth the gaps are printed.
# whisper-medium (src/repro_torch/configs/whisper_medium.py): 24 encoder
# and 24 decoder layers, d_model 1024, 16 heads of 64, vocab 51865; 0.811 B
# parameters (3.24 GB float32), bf16 compute over float32 weights random
# from a seeded card generator. Two queues through ServeEngine.serve_queue,
# every lane batch carrying frames_for's (4, 1500, 1024) frame embeddings:
# the launcher's (8 requests of 16-token prompts, batch 4, 16 new) and 8
# requests of 128-token prompts: (label, requests, prompt length, batch,
# max_new, max_len). A prefill launches flash_attention_fwd n_enc + 2
# n_layers = 72 times (the encoder, the decoder's self- and
# cross-attention), a decode step n_layers = 24 (its cross-attention, as
# the reference's decode runs it); the cross K/V caches hold 295 MB a
# batch row. At its random init whisper amplifies a rounding: a relative
# change of 1e-7 in the frames moves the float32 last logits by 2.3e-4 of
# the largest at one encoder and one decoder layer, 3.4e-2 at two of each,
# 0.74 at 24 (tools/lm_sensitivity.py on the card; the attention scores
# reach ~200, so a softmax turns a rounding of a score into a change of its
# weights). So decode against prefill (float32, 2e-3) is gated on a copy
# cut to AUDIO_CHECK_LAYERS encoder and decoder layer at full width, and
# at full depth printed. Card against CPU runs on such a copy: the decode
# logits within TOL_LM_CPU, tokens equal where the CPU's top-2 margin
# exceeds it, and the forward's logits at every position within
# AUDIO_ROUTE_FACTOR of the distance the card's plain attention route
# (``flash_attention_blocks``, the CPU's function) keeps from the CPU, or
# TOL_LM_CPU: a 1e-7 change moves them 1.8e-3 there, over the gate itself.
AUDIO_ARCH = "whisper-medium"
AUDIO_QUEUES = (("launcher", 8, 16, 4, 16, 128), ("long prompts", 8, 128, 4, 16, 256))
AUDIO_CHECK_LAYERS = 1
AUDIO_ROUTE_FACTOR = 2.0
# fourier_lm (src/repro_torch/configs/fourier_lm.py): 12 FNet blocks,
# d_model 512, d_ff 2048, vocab 32768; 58.7 M parameters, bf16 compute over
# float32 weights. make_batch's MLM batch of 8 sequences of 2048 tokens:
# each block's Re(FFT2) is one planned complex fft2 of (8, 2048, 512), the
# composed route (fft_fused rows, fft2_columns) by the census. Card against
# CPU at float32 compute, full depth, on the batch's first
# SPECTRAL_CHECK_BATCH sequences, within TOL_LM_CPU.
# The moe lm phase: the moe family at full width on one card, cut
# in depth (neither fits whole: mixtral-8x22b 140.6 B parameters,
# deepseek-v3-671b 671.7 B). mixtral: 2 layers of GQA (48 heads of 128, 8
# kv heads, a sliding window of 4096 with its ring cache) and 8 experts of
# 16384 top-2, vocab 32768: 5.41 B parameters, float32 weights. deepseek: 1
# dense MLA layer (d_ff 18432) and 1 MLA layer with 256 routed experts
# (top-8) of 2048 and one shared, the MTP head, vocab 129280: 14.63 B, the
# routed experts held and drawn in bf16 (``moe.with_expert_dtype``: the
# reference casts them to the bf16 compute dtype before every product, so
# these are its products of float32 weights rounded once; 22.5 GB, not
# 45), every other leaf float32. bf16 compute, weights from a seeded card
# generator. (arch, layers, leading dense layers, bf16 experts, queues as
# LM_QUEUES, (s, rows) of the float32 decode-vs-prefill gate on the served
# weights, the check copy's (layers, dense layers, routed experts)).
# mixtral's window lane: 2 prompts of 8192 (a multiple of the window, so
# the first decode step evicts the oldest slot; see
# test_ring_decode_after_a_prefill_past_the_window_keeps_the_reference_slots).
MOE_ARCHS = (
    ("mixtral-8x22b", 2, 0, False,
     (("launcher", 8, 16, 4, 16, 128), ("window lane", 2, 8192, 2, 16, 8208)),
     ((16, 4), (8192, 1)), (1, 0, None)),
    ("deepseek-v3-671b", 2, 1, True,
     (("launcher", 8, 16, 4, 16, 128), ("long prompts", 4, 1024, 4, 16, 1040)),
     (), (2, 1, 32)),
)
# deepseek's loss_fn once on (2, 1024) tokens under no_grad: the two layers,
# then the MTP block, each one flash_attention_fwd.
MOE_LOSS_BATCH = (2, 1024)
# Decode against the prefill of s + 1 is gated (float32, TOL_LM_F32_GOLDEN)
# at capacity factor E / k, where a row's capacity is S and nothing is
# dropped: at the configs' 1.25 a prefill drops over-capacity assignments
# and a decode step never does, so the two are different functions (printed
# at bf16 only). deepseek's gate runs on the check copy (float32 compute on
# its served weights would cast the bf16 experts to a 45 GB float32 copy):
# lanes s 16 (4 rows) and 1024 (2 rows). Card against CPU on the check copy
# at float32: logits within TOL_LM_CPU, tokens equal wherever the CPU's
# top-2 margin exceeds it, and every moe layer's expert ids equal the
# CPU's unless the CPU's score margin at the k-th expert is 0 (a tie).
MOE_CHECK_GOLDEN = ((16, 4), (1024, 2))
SPECTRAL_ARCH = "fourier_lm"
SPECTRAL_BATCH = (8, 2048)
SPECTRAL_CHECK_BATCH = 2
SERVE_MIX = (256, 128, 128)
SERVE_BATCH = 16
SERVE_CT = (32, 512, 512)
SERVE_HOLO = (16, 1024, 1024)
SERVE_REG = (8, 256, 10)           # pairs a lane, side, upsample of the fine lane
SERVE_CONV = (4, 1024, 31)         # requests, side, kernel side
SERVE_RECON = (4, 16, 256, 256)    # requests, coils, H, W
SERVE_LOOP = (4, 32, 8, 0.002)     # submitter threads, frames each, max_batch, max_wait_s
SERVE_WISDOM = (128, 256, 512)
SERVE_KERNELS = ("fft2_fused", "rfft2_fused", "fft_fused", "rfft_fused", "fft2_columns")
# Events that mark a degrade: none may fire on the main path.
DEGRADE_EVENTS = ("resilience.failover", "resilience.fault", "plan.degrade")
COOLDOWN_S = 30.0      # the breaker's cooldown, driven by an injected clock
# The fused wrappers the kernel entries of repro_torch.kernels.ops call,
# and the plain schedules of repro_torch.core.fft1d under every core entry.
FUSED_WRAPPERS = ("fft_fused", "rfft_fused", "irfft_fused", "fft2_fused", "rfft2_fused",
                  "irfft2_fused", "fft2_columns")
PLAIN_SCHEDULES = ("_fft_panel", "_fft_routed")
ROW_KERNELS = ("fft_fused", "rfft_fused", "irfft_fused", "fft_two_pass", "fft_cluster")
FRAME_KERNELS = ("fft2_fused", "rfft2_fused", "irfft2_fused")
# The composed 2D route's column pass, and the frames over one block on
# which the route is timed against the turn route it replaced and against
# torch.fft: MRI k-space, CT and hologram sizes.
COLUMNS = "fft2_columns"
COMPOSED_SHAPES = ((64, 256, 256), (32, 512, 512), (16, 1024, 1024))
# fft2_columns against its plain version beyond the kernel phase's
# (32, 512, 512): half-spectrum widths (a partial last panel), panels of 8
# and 4 columns (H 2048, 4096) and one-pass columns (H 8).
COLUMN_SHAPES = ((64, 256, 129), (16, 1024, 513), (8, 2048, 512), (4, 4096, 257),
                 (512, 8, 4096))


def bound(card: str, cost, flop_rate: float = PEAK_FLOPS_FP32):
    """(bound_ms, bound_by) of a kernel's ``cost`` (the ``Cost`` of its
    module's cost function): the larger of its bytes over HBM bandwidth and
    its float32 operations over ``flop_rate``, by default the card's rate
    outside the tensor cores."""
    bytes_ms = cost.bytes / hbm_bandwidth(card) * 1e3
    ops_ms = cost.flops / flop_rate * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def kernel_phase(torch, k, card: str):
    """Each kernel against its plain version; returns the per-kernel rows."""
    from repro_torch.kernels import _build

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=gen, device=dev),
                             torch.randn(*shape, generator=gen, device=dev))

    b, n = 8192, 2048
    cases = {
        "fft_fused": (crandn(b, n), k.fft_fused, k.fft_fused_plain,
                      lambda x: torch.fft.fft(x), k.fft_cost(b, n)),
        "rfft_fused": (torch.randn(b, n, generator=gen, device=dev), k.rfft_fused,
                       k.rfft_fused_plain, lambda x: torch.fft.rfft(x), k.rfft_cost(b, n)),
        "irfft_fused": (crandn(b, n // 2 + 1), k.irfft_fused, k.irfft_fused_plain,
                        lambda x: torch.fft.irfft(x), k.rfft_cost(b, n)),
        "fft2_fused": (crandn(512, 128, 128), k.fft2_fused, k.fft2_fused_plain,
                       lambda x: torch.fft.fft2(x), k.fft2_cost(512, 128, 128)),
        "rfft2_fused": (torch.randn(512, 128, 128, generator=gen, device=dev), k.rfft2_fused,
                        k.rfft2_fused_plain, lambda x: torch.fft.rfft2(x),
                        k.rfft2_cost(512, 128, 128)),
        "irfft2_fused": (crandn(512, 128, 65), k.irfft2_fused, k.irfft2_fused_plain,
                         lambda x: torch.fft.irfft2(x), k.rfft2_cost(512, 128, 128)),
        # The column pass alone on the CT frames: its library call is the
        # column FFT (dim -2); one read and one write of every value.
        COLUMNS: (crandn(*CT), k.fft2_columns, k.fft2_columns_plain,
                  lambda x: torch.fft.fft(x, dim=-2), k.fft2_columns_cost(*CT)),
    }
    rows = {}
    for name, (x, kernel, plain, library, cost) in cases.items():
        by_radix = {}
        for radix in (2, 4):
            got = kernel(x, radix=radix)
            ref = plain(x, radix=radix)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            by_radix[str(radix)] = {
                "rel_err": err,
                "max_abs_err": max_abs(got, ref),
                "ms": time_ms(lambda: kernel(x, radix=radix)),
                "plain_ms": time_ms(lambda: plain(x, radix=radix), reps=2, batches=3),
            }
            if not err <= TOL_KERNEL:
                raise AssertionError(f"{name} radix {radix}: rel err {err} > {TOL_KERNEL}")
            emit({"phase": "kernel", "kernel": name, "radix": radix,
                  "shape": list(x.shape), **by_radix[str(radix)]})
        bound_ms, bound_by = bound(card, cost)
        r4 = by_radix["4"]
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": 0,
            "max_abs_err": max(v["max_abs_err"] for v in by_radix.values()),
            "rel_err": max(v["rel_err"] for v in by_radix.values()),
            "ms": r4["ms"],
            "plain_ms": r4["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(lambda: library(x)),
            "shape": list(x.shape),
            "by_radix": by_radix,
        }
        if name in ("fft_fused", "rfft_fused", "irfft_fused"):
            real, inverse = name != "fft_fused", name == "irfft_fused"
            line = {"phase": "kernel", "kernel": name, "design": "register passes (radix 4)",
                    "shape": list(x.shape), "passes_per_row": len(k.regpass_radices(
                        n // 2 if real else n)),
                    "exchanges_per_row": k.regpass_exchanges(n, real=real, inverse=inverse),
                    "barriers_per_row": k.regpass_barriers(n, real=real, inverse=inverse),
                    "mirror_bins_paired_in_registers": (k.rfft_pairs_in_registers(n // 2)
                                                        if real and not inverse else None),
                    "ms": r4["ms"], "stage_panel_ms_recorded": STAGE_PANEL_R4_MS[name],
                    "library_ms": rows[name]["library_ms"], "bound_ms": bound_ms}
            if inverse:
                line["ptxas"] = ptxas_entries(_build.build_log(), ROW_PASS_ENTRIES[name]).get(
                    ((n // 2).bit_length() - 1, 4))
            emit(line)
            if name in ROW_PASS_ENTRIES:
                radix2_rows(torch, k, name, rows[name], crandn, gen)
        elif name in FRAME_REGS_ENTRIES:
            frame_line(name, x.shape, r4["ms"], rows[name]["library_ms"], bound_ms)
            if name in FRAME_R2_KERNELS:
                frame_r2_line(name, x.shape, by_radix, rows[name]["library_ms"], bound_ms)
        elif name == COLUMNS:
            column_lines(torch, k, rows[name], crandn, card)
        del x
        torch.cuda.empty_cache()
    non_square_frames(torch, k, card, rows, crandn, gen)
    return rows


def radix2_rows(torch, k, name, row, crandn, gen):
    """The radix-2 register-pass kernel's design line (passes, exchanges
    and barriers a row; ptxas's registers and spills of each instance, 0
    spilled the gate; the recorded stage-panel time beside this run's, the
    library's and the bound), then the kernel against its plain version at
    every one-block length n = 2 ... 2^14 (fft_fused forward and inverse;
    irfft_fused on half spectra that are not Hermitian), on a batch that
    leaves the last row tile masked wherever a tile holds more than one
    row; the worst error joins the kernel's row."""
    from repro_torch.kernels import _build

    n = row["shape"][1]
    real, inverse = name != "fft_fused", name == "irfft_fused"
    if inverse:  # a half spectrum
        n = 2 * (n - 1)
    line_len = n // 2 if real else n
    instances = {args[0]: v for args, v in
                 ptxas_entries(_build.build_log(), ROW_PASS_ENTRIES[name]).items()
                 if len(args) == 2 and args[1] == 2}
    want = range(0, 14) if real else range(1, 15)
    spilled = {lg: v for lg, v in instances.items() if v.get("spill_stores")}
    line = {"phase": "kernel", "kernel": name, "design": "register passes (radix 2)",
            "shape": row["shape"], "passes": list(k.regpass_radices(line_len)),
            "passes_per_row": len(k.regpass_radices(line_len)),
            "exchanges_per_row": k.regpass_exchanges(n, real=real, inverse=inverse, radix=2),
            "barriers_per_row": k.regpass_barriers(n, real=real, inverse=inverse, radix=2),
            "mirror_bins_paired_in_registers": (k.rfft_pairs_in_registers(line_len)
                                                if real and not inverse else None),
            "ptxas": {str(lg): instances[lg] for lg in sorted(instances)},
            "ms": row["by_radix"]["2"]["ms"], "stage_panel_ms_recorded": STAGE_PANEL_R2_MS[name],
            "library_ms": row["library_ms"], "bound_ms": row["bound_ms"]}
    emit(line)
    if sorted(instances) != list(want):
        raise AssertionError(f"{name} radix 2: instances {sorted(instances)} in the build log, "
                             f"want log2 lengths {list(want)}")
    if spilled:
        raise AssertionError(f"{name} radix 2: instances spill registers: {spilled}")
    worst = 0.0
    for p in range(1, 15):
        m = 2 ** p
        tile = k.pick_row_tile(1 << 30, m // 2 if real else m)
        batch = 2 * tile - 1 if tile > 1 else 3
        if inverse:
            y = crandn(batch, m // 2 + 1)
            errs = [rel_err(k.irfft_fused(y, radix=2), k.irfft_fused_plain(y, radix=2))]
        elif real:
            x = torch.randn(batch, m, generator=gen, device="cuda")
            errs = [rel_err(k.rfft_fused(x, radix=2), k.rfft_fused_plain(x, radix=2))]
        else:
            x = crandn(batch, m)
            errs = [rel_err(k.fft_fused(x, radix=2, inverse=inv),
                            k.fft_fused_plain(x, radix=2, inverse=inv)) for inv in (False, True)]
        worst = max(worst, *errs)
        if not max(errs) <= TOL_KERNEL:
            raise AssertionError(f"{name} radix 2 at n {m}, batch {batch}: rel err {max(errs)} "
                                 f"> {TOL_KERNEL}")
    emit({"phase": "kernel", "kernel": name, "radix": 2, "every_length": [2, 2 ** 14],
          "rel_err": worst})
    row["rel_err"] = max(row["rel_err"], worst)


def frame_line(name, shape, ms, library_ms, bound_ms):
    """The radix-4 whole-frame kernel's design line: passes, exchanges and
    barriers per frame, threads and shared memory of its block, ptxas's
    registers and spills of each radix-4 instance, and the recorded
    stage-panel time."""
    from repro_torch.kernels import fft_radix2 as k

    _, h, w = shape
    real, inverse = name != "fft2_fused", name == "irfft2_fused"
    if inverse:  # a half spectrum
        w = 2 * (w - 1)
    fp = k.frame_passes(h, w, real=real, inverse=inverse)
    values = h * (w // 2 if real else w)
    emit({"phase": "kernel", "kernel": name, "design": "register passes (radix 4)",
          "shape": list(shape), "row_passes": list(fp.rows), "column_passes": list(fp.cols),
          "exchanges_per_frame": fp.exchanges, "barriers_per_frame": fp.barriers,
          "threads": k.block_threads(values),
          "smem_bytes": (k.rfft2_smem_bytes if real else k.fft2_smem_bytes)(h, w),
          "ptxas": {",".join(map(str, a)): v for a, v in sorted(frame_instances(name, 4).items())},
          "ms": ms, "stage_panel_ms_recorded": STAGE_PANEL_R4_MS.get(name),
          "library_ms": library_ms, "bound_ms": bound_ms})


def frame_instances(name, radix):
    """ptxas's registers and spills of a whole-frame kernel's instances at
    ``radix``, keyed (log2 H, log2 of the row's values): the entries whose
    template arguments end in the radix."""
    from repro_torch.kernels import _build

    return {args[:2]: v for args, v in
            ptxas_entries(_build.build_log(), FRAME_REGS_ENTRIES[name]).items()
            if args[2] == radix}


def frame_r2_line(name, shape, by_radix, library_ms, bound_ms):
    """The radix-2 whole-frame kernel's design line (its frame passes,
    ptxas's registers and spills of its radix-2 instances, 0 spilled the
    gate) with its time beside radix 4's, the library's, the bound and the
    recorded stage-panel time."""
    from repro_torch.kernels import fft_radix2 as k

    _, h, w = shape
    real, inverse = name != "fft2_fused", name == "irfft2_fused"
    if inverse:  # a half spectrum
        w = 2 * (w - 1)
    fp = k.frame_passes(h, w, real=real, inverse=inverse)
    ptxas = frame_instances(name, 2)
    want = (IRFFT2_R2_INSTANCES if inverse
            else [(0, 0), (7, 6) if real else (7, 7)])
    emit({"phase": "kernel", "kernel": name, "design": "register passes (radix 2)",
          "shape": list(shape), "row_passes": list(fp.rows), "column_passes": list(fp.cols),
          "exchanges_per_frame": fp.exchanges, "barriers_per_frame": fp.barriers,
          "ptxas": {",".join(map(str, a)): v for a, v in sorted(ptxas.items())},
          "ms": by_radix["2"]["ms"], "radix4_ms": by_radix["4"]["ms"],
          "stage_panel_ms_recorded": STAGE_PANEL_FRAME_R2_MS.get((name, tuple(shape))),
          "library_ms": library_ms, "bound_ms": bound_ms})
    if sorted(ptxas) != want:
        raise AssertionError(f"{name} radix 2: instances {sorted(ptxas)} in the build log, "
                             f"want {want}")
    spilled = {a: v for a, v in ptxas.items() if v.get("spill_stores")}
    if spilled:
        raise AssertionError(f"{name} radix 2: instances spill registers: {spilled}")


def column_lines(torch, k, row, crandn, card):
    """fft2_columns's design lines on the CT frames (the panel's columns,
    threads and shared memory, its passes, ptxas's registers and spills of
    each radix's instance; radix 2 beside radix 4, the library, the bound
    and the recorded stage-panel time, 0 spilled its gate), then the kernel
    against its plain version on COLUMN_SHAPES and, at radix 2, at every
    height the census serves, at both radices, in place and into a new
    buffer; the worst error joins its row."""
    from repro_torch.kernels import _build

    f, h, w = CT
    g = k.fft2_columns_geometry(h, w)
    ptxas = {args[0]: v for args, v in ptxas_entries(_build.build_log(), COLUMNS_ENTRY).items()}
    common = {"phase": "kernel", "kernel": COLUMNS, "shape": list(CT), "card": card,
              "cols": g.cols, "panels_per_frame": g.tiles, "threads": g.threads,
              "smem_bytes": g.smem, "column_passes": list(k.regpass_radices(h))}
    emit({**common, "design": "column panels in place (register passes, radix 4)",
          "ptxas": ptxas.get(4), "ms": row["ms"], "library_ms": row["library_ms"],
          "bound_ms": row["bound_ms"]})
    emit({**common, "design": "column panels in place (register passes, radix 2)",
          "ptxas": ptxas.get(2), "ms": row["by_radix"]["2"]["ms"], "radix4_ms": row["ms"],
          "stage_panel_ms_recorded": STAGE_PANEL_FRAME_R2_MS[(COLUMNS, CT)],
          "library_ms": row["library_ms"], "bound_ms": row["bound_ms"]})
    if sorted(ptxas) != [2, 4]:
        raise AssertionError(f"fft2_columns: instances {sorted(ptxas)} in the build log, "
                             "want radix 2 and 4")
    if ptxas[2].get("spill_stores"):
        raise AssertionError(f"fft2_columns radix 2: the instance spills registers: {ptxas[2]}")
    worst = 0.0
    for p in range(1, 13):  # H = 2 ... 4096, a width that leaves the last panel masked
        hh = 2 ** p
        cols = k.fft2_columns_geometry(hh, 1 << 20).cols
        x = crandn(3, hh, 2 * cols + 1)
        for inverse in (False, True):
            ref = k.fft2_columns_plain(x, radix=2, inverse=inverse)
            got = k.fft2_columns(x, radix=2, inverse=inverse)
            same = x.clone()
            k.fft2_columns(same, radix=2, inverse=inverse, out=same)
            torch.cuda.synchronize()
            err = max(rel_err(got, ref), rel_err(same, ref))
            worst = max(worst, err)
            if not err <= TOL_KERNEL:
                raise AssertionError(f"fft2_columns radix 2 at H {hh}, width {2 * cols + 1}, "
                                     f"inverse {inverse}: rel err {err} > {TOL_KERNEL}")
            row["max_abs_err"] = max(row["max_abs_err"], max_abs(got, ref), max_abs(same, ref))
            del ref, got, same
    emit({"phase": "kernel", "kernel": COLUMNS, "radix": 2, "every_height": [2, 4096],
          "rel_err": worst})
    row["rel_err"] = max(row["rel_err"], worst)
    for shape in COLUMN_SHAPES:
        x = crandn(*shape)
        for radix in (2, 4):
            for inverse in (False, True):
                ref = k.fft2_columns_plain(x, radix=radix, inverse=inverse)
                got = k.fft2_columns(x, radix=radix, inverse=inverse)
                same = x.clone()
                k.fft2_columns(same, radix=radix, inverse=inverse, out=same)
                torch.cuda.synchronize()
                err = max(rel_err(got, ref), rel_err(same, ref))
                one = {"phase": "kernel", "kernel": COLUMNS, "shape": list(shape),
                       "radix": radix, "inverse": inverse,
                       "cols": k.fft2_columns_geometry(shape[1], shape[2]).cols,
                       "rel_err": err, "max_abs_err": max(max_abs(got, ref), max_abs(same, ref))}
                emit(one)
                if not err <= TOL_KERNEL:
                    raise AssertionError(f"fft2_columns {shape} radix {radix} inverse "
                                         f"{inverse}: rel err {err} > {TOL_KERNEL}")
                row["rel_err"] = max(row["rel_err"], err)
                row["max_abs_err"] = max(row["max_abs_err"], one["max_abs_err"])
                del ref, got, same
        del x
        torch.cuda.empty_cache()


def ptxas_entries(log: str, fragment: str):
    """Registers and spill bytes ptxas reported for each instance of the
    kernel whose mangled name holds ``fragment``, keyed by its integer
    template arguments: {(7, 7, 4): {...}} ((0, 0, radix) the frame kernels'
    runtime geometry; (log2 m, radix) for irfft_regs_kernel; (log2 C, log2
    M, kind) for fft_cluster_kernel; () for a kernel that is no template)."""
    import re

    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            key = None
            entry = re.search(fragment + r"(?:I((?:Li\d+E)+)E)?", line)
            if entry:
                key = tuple(int(v) for v in re.findall(r"Li(\d+)E", entry[1] or ""))
                out[key] = {}
        elif key is not None and "spill stores" in line:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[key].update(spill_stores=int(spills[1]), spill_loads=int(spills[2]))
        elif key is not None and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
            key = None
    return out


def non_square_frames(torch, k, card, rows, crandn, gen):
    """fft2_fused on wide frames, rfft2_fused on tall ones and irfft2_fused
    on their half spectra, at radix 2 and 4, against their plain versions;
    each line gives the times beside the library call and the bound, and
    the kernel's row keeps the case."""
    dev = torch.device("cuda")
    fw, hw, ww = FRAME_WIDE
    ft, ht, wt = FRAME_TALL
    cases = {  # name: (input, kernel, plain, library, cost)
        "fft2_fused": (crandn(*FRAME_WIDE), k.fft2_fused, k.fft2_fused_plain, torch.fft.fft2,
                       k.fft2_cost(fw, hw, ww)),
        "rfft2_fused": (torch.randn(*FRAME_TALL, generator=gen, device=dev), k.rfft2_fused,
                        k.rfft2_fused_plain, torch.fft.rfft2, k.rfft2_cost(ft, ht, wt)),
        "irfft2_fused": (crandn(ft, ht, wt // 2 + 1), k.irfft2_fused, k.irfft2_fused_plain,
                         torch.fft.irfft2, k.rfft2_cost(ft, ht, wt)),
    }
    for name, (x, kernel, plain, library, cost) in cases.items():
        bound_ms, bound_by = bound(card, cost)
        case = {"shape": list(x.shape), "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": time_ms(lambda: library(x)), "by_radix": {}}
        for radix in (2, 4):
            got = kernel(x, radix=radix)
            ref = plain(x, radix=radix)
            torch.cuda.synchronize()
            one = {"rel_err": rel_err(got, ref), "max_abs_err": max_abs(got, ref),
                   "ms": time_ms(lambda: kernel(x, radix=radix)),
                   "plain_ms": time_ms(lambda: plain(x, radix=radix), reps=2, batches=3)}
            del got, ref
            case["by_radix"][str(radix)] = one
            emit({"phase": "kernel", "kernel": name, "radix": radix, "shape": list(x.shape),
                  **one})
            if not one["rel_err"] <= TOL_KERNEL:
                raise AssertionError(f"{name} {tuple(x.shape)} radix {radix}: rel err "
                                     f"{one['rel_err']} > {TOL_KERNEL}")
        r4 = case["by_radix"]["4"]
        frame_line(name, x.shape, r4["ms"], case["library_ms"], bound_ms)
        if name in FRAME_R2_KERNELS:
            frame_r2_line(name, x.shape, case["by_radix"], case["library_ms"], bound_ms)
        row = rows[name]
        row["non_square"] = case
        row["max_abs_err"] = max(row["max_abs_err"],
                                 *(v["max_abs_err"] for v in case["by_radix"].values()))
        row["rel_err"] = max(row["rel_err"], *(v["rel_err"] for v in case["by_radix"].values()))
        del x
        torch.cuda.empty_cache()


def composed_phase(torch, k, card: str):
    """The composed 2D route on frames over one block (COMPOSED_SHAPES), at
    the kernel entries ``ops.fft2_kernel`` / ``rfft2_kernel`` /
    ``irfft2_kernel`` (radix 4): one row kernel and one fft2_columns launch
    a call, held to the plain route (the row pass's and fft2_columns's
    plain versions) and to ``torch.fft`` at 2e-5. Each line gives the
    route's time at the entry and the host's time to enqueue a call there
    (where that is the larger, the entry is host-bound), the route's two
    launches called directly (``direct_ms``), its row pass and column pass
    alone, the turn route it replaced (composed here from the same wrappers
    and torch transposes: rows, a turn, ``fft_fused`` on the columns as
    rows, a turn back; each turn's time alone; set against ``direct_ms``),
    ``torch.fft``'s time, the one-trip HBM bound (input read and output
    written once) and the floor of the route's two trips."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(26)
    dev = torch.device("cuda")
    rows_of = {"fft2": "fft_fused", "rfft2": "rfft_fused", "irfft2": "irfft_fused"}

    def turn(z, f, a, b):  # (f, a, b) -> (f, b, a), through HBM
        return z.reshape(f, a, b).transpose(-1, -2).contiguous()

    for shape in COMPOSED_SHAPES:
        f, h, w = shape
        n, half = f * h * w, w // 2 + 1
        nh = f * h * half
        real = torch.randn(*shape, generator=gen, device=dev)
        cases = {  # the kind's input
            "fft2": real.to(torch.complex64),
            "rfft2": real,
            "irfft2": torch.fft.rfft2(real),
        }
        for name, x in cases.items():
            entry = getattr(ops, f"{name}_kernel")
            if name == "fft2":
                rows_in = x.reshape(f * h, w)
                one_trip, two_trip = 16 * n, 32 * n
                row = lambda: k.fft_fused(rows_in, radix=4)
                mid = row()
                cols = lambda: k.fft2_columns(mid.reshape(f, h, w), radix=4)
                plain = lambda: k.fft2_columns_plain(
                    k.fft_fused_plain(rows_in, radix=4).reshape(f, h, w), radix=4)
                turn_in, t_a, t_b = mid, (f, h, w), (f, w, h)
                turned = lambda z: k.fft_fused(z.reshape(f * w, h), radix=4)

                def turn_route():
                    y = k.fft_fused(rows_in, radix=4)
                    y = k.fft_fused(turn(y, f, h, w).reshape(f * w, h), radix=4)
                    return turn(y, f, w, h)

                def direct():
                    y = k.fft_fused(rows_in, radix=4).reshape(f, h, w)
                    return k.fft2_columns(y, radix=4, out=y)
            elif name == "rfft2":
                rows_in = x.reshape(f * h, w)
                one_trip, two_trip = 4 * n + 8 * nh, 4 * n + 24 * nh
                row = lambda: k.rfft_fused(rows_in, radix=4)
                mid = row()
                cols = lambda: k.fft2_columns(mid.reshape(f, h, half), radix=4)
                plain = lambda: k.fft2_columns_plain(
                    k.rfft_fused_plain(rows_in, radix=4).reshape(f, h, half), radix=4)
                turn_in, t_a, t_b = mid, (f, h, half), (f, half, h)
                turned = lambda z: k.fft_fused(z.reshape(f * half, h), radix=4)

                def turn_route():
                    y = k.rfft_fused(rows_in, radix=4)
                    y = k.fft_fused(turn(y, f, h, half).reshape(f * half, h), radix=4)
                    return turn(y, f, half, h)

                def direct():
                    y = k.rfft_fused(rows_in, radix=4).reshape(f, h, half)
                    return k.fft2_columns(y, radix=4, out=y)
            else:
                one_trip, two_trip = 8 * nh + 4 * n, 24 * nh + 4 * n
                mid = k.fft2_columns(x, radix=4, inverse=True)
                cols = lambda: k.fft2_columns(x, radix=4, inverse=True)
                row = lambda: k.irfft_fused(mid.reshape(f * h, half), radix=4)
                plain = lambda: k.irfft_fused_plain(k.fft2_columns_plain(
                    x, radix=4, inverse=True).reshape(f * h, half), radix=4).reshape(f, h, w)
                turn_in, t_a, t_b = x, (f, h, half), (f, half, h)
                turned = lambda z: k.fft_fused(z.reshape(f * half, h), radix=4, inverse=True)

                def turn_route():
                    y = k.fft_fused(turn(x, f, h, half).reshape(f * half, h), radix=4,
                                    inverse=True)
                    return k.irfft_fused(turn(y, f, half, h).reshape(f * h, half), radix=4)

                def direct():
                    y = k.fft2_columns(x, radix=4, inverse=True)
                    return k.irfft_fused(y.reshape(f * h, half), radix=4)
            before = dict(k.LAUNCHES)
            got = entry(x, radix=4)
            torch.cuda.synchronize()
            launches = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES
                        if k.LAUNCHES[kn] != before[kn]}
            ref = plain()
            lib = getattr(torch.fft, name)(x)
            old = turn_route().reshape(got.shape)
            second_in = turned(turn(turn_in, *t_a))
            bound_ms = one_trip / hbm_bandwidth(card) * 1e3
            line = {"phase": "kernel", "kernel": COLUMNS, "route": f"composed {name}",
                    "shape": list(x.shape), "card": card, "radix": 4,
                    "launches_per_call": launches,
                    "rel_err_vs_plain": rel_err(got, ref), "max_abs_err": max_abs(got, ref),
                    "rel_err_vs_library": rel_err(got, lib),
                    "turn_route_rel_err_vs_library": rel_err(old, lib),
                    "ms": time_ms(lambda: entry(x, radix=4)),
                    "host_ms": enqueue_ms(torch, lambda: entry(x, radix=4)),
                    "direct_ms": time_ms(direct),
                    "row_ms": time_ms(row), "columns_ms": time_ms(cols),
                    "turn_route_ms": time_ms(turn_route),
                    "turn_ms": [time_ms(lambda: turn(turn_in, *t_a)),
                                time_ms(lambda: turn(second_in, *t_b))],
                    "library_ms": time_ms(lambda: getattr(torch.fft, name)(x)),
                    "one_trip_bound_ms": bound_ms,
                    "two_trip_floor_ms": two_trip / hbm_bandwidth(card) * 1e3}
            line["over_two_trip_floor"] = line["ms"] / line["two_trip_floor_ms"]
            line["turn_route_over_route"] = line["turn_route_ms"] / line["direct_ms"]
            emit(line)
            want = {rows_of[name]: 1, COLUMNS: 1}
            if launches != want:
                raise AssertionError(f"composed {name} {shape}: launches {launches}, "
                                     f"want {want}")
            for what in ("rel_err_vs_plain", "rel_err_vs_library"):
                if not line[what] <= TOL_KERNEL:
                    raise AssertionError(f"composed {name} {shape}: {what} {line[what]} "
                                         f"> {TOL_KERNEL}")
            del got, ref, lib, old, mid, second_in, x
        del real, cases
        torch.cuda.empty_cache()


def two_pass_phase(torch, k, card: str):
    """fft_two_pass (fft_fused, rfft_fused and irfft_fused at radix 2 on
    rows over one block, both passes on register passes) against its plain
    versions; returns its row. Each call must launch it twice (complex) or
    three times (real). Its design line gives each pass's register passes,
    panel or tile, threads and shared memory, and ptxas's registers and
    spills of every instance (0 spilled the gate); every kind is also held
    to its plain version at both shapes and at every row length the two
    passes serve (N = 2^15 ... 2^18, then 2^19 ... 2^24 at both radices
    beside torch.fft, and one batch past 2^31 values); then the two passes
    and the cluster side by side at N = 2^15 ... 2^18."""
    from repro_torch.kernels import _build

    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=gen, device=dev),
                             torch.randn(*shape, generator=gen, device=dev))

    bc, nc = TWO_PASS_COMPLEX
    br, nr = TWO_PASS_REAL
    x = crandn(bc, nc)
    cases = {  # name: (input, kernel, plain, library, cost of one trip, trips)
        "fft": (x, k.fft_fused, k.fft_two_pass_plain, torch.fft.fft, k.fft_cost(bc, nc), 2),
        "ifft": (x, lambda z, radix: k.fft_fused(z, radix=radix, inverse=True),
                 lambda z, radix: k.fft_two_pass_plain(z, radix=radix, inverse=True),
                 torch.fft.ifft, k.fft_cost(bc, nc), 2),
        "rfft": (torch.randn(br, nr, generator=gen, device=dev), k.rfft_fused,
                 k.rfft_two_pass_plain, torch.fft.rfft, k.rfft_cost(br, nr), 3),
        "irfft": (crandn(br, nr // 2 + 1), k.irfft_fused, k.irfft_two_pass_plain,
                  torch.fft.irfft, k.rfft_cost(br, nr), 3),
    }
    log = _build.build_log()
    ptxas = {kind: ptxas_entries(log, frag) for kind, frag in TWO_PASS_ENTRIES.items()}
    geo = {n: k.two_pass_geometry(n) for n in (nc, nr // 2, *LONG_ROWS)}
    emit({"phase": "kernel", "kernel": "fft_two_pass", "design": "register passes (radix 2)",
          "by_row": {str(n): {"split": [g.n1, g.n2],
                              "column_passes": list(k.regpass_radices(g.n1)),
                              "row_passes": list(k.regpass_radices(g.n2)),
                              "exchanges": [k.regpass_exchanges(g.n1), k.regpass_exchanges(g.n2)],
                              "cols": g.cols, "col_threads": g.col_threads,
                              "col_smem": g.col_smem, "rows": g.rows,
                              "row_threads": g.row_threads, "row_smem": g.row_smem}
                     for n, g in geo.items()},
          "ptxas": {kind: {",".join(map(str, a)): v for a, v in sorted(e.items())}
                    for kind, e in ptxas.items()}})
    want = {kind: [(7, 5), (8, 4), (9, 4), *LONG_ROW_INSTANCES[kind]]
            for kind in ("columns", "rows")}
    if {kind: sorted(e) for kind, e in ptxas.items()} != want:
        raise AssertionError(f"fft_two_pass: instances {ptxas} in the build log, want {want}")
    spilled = {(kind, a): v for kind, e in ptxas.items() for a, v in e.items()
               if v.get("spill_stores")}
    if spilled:
        raise AssertionError(f"fft_two_pass: instances spill registers: {spilled}")
    by_case = {}
    for name, (z, kernel, plain, library, cost, trips) in cases.items():
        by_radix = {}
        for radix in (2,):
            before = k.LAUNCHES["fft_two_pass"]
            got = kernel(z, radix=radix)
            launched = k.LAUNCHES["fft_two_pass"] - before
            ref = plain(z, radix=radix)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            by_radix[str(radix)] = {
                "rel_err": err,
                "max_abs_err": max_abs(got, ref),
                "ms": time_ms(lambda: kernel(z, radix=radix)),
                "plain_ms": time_ms(lambda: plain(z, radix=radix), reps=2, batches=3),
            }
            del got, ref
            emit({"phase": "kernel", "kernel": "fft_two_pass", "case": name, "radix": radix,
                  "shape": list(z.shape), "launches_per_call": launched,
                  **by_radix[str(radix)]})
            if not err <= TOL_KERNEL:
                raise AssertionError(f"fft_two_pass {name} radix {radix}: rel err {err} "
                                     f"> {TOL_KERNEL}")
            if launched != trips:
                raise AssertionError(f"fft_two_pass {name}: {launched} launches, not {trips}")
        bound_ms, bound_by = bound(card, cost)
        by_case[name] = {"shape": list(z.shape), "ms": by_radix["2"]["ms"],
                         "plain_ms": by_radix["2"]["plain_ms"],
                         "library_ms": time_ms(lambda: library(z)), "bound_ms": bound_ms,
                         "bound_by": bound_by, "by_radix": by_radix}
        emit({"phase": "kernel", "kernel": "fft_two_pass", "case": name,
              "shape": list(z.shape), "bound_ms": bound_ms, "round_trips": trips,
              "floor_ms": trips * bound_ms, "ms": by_radix["2"]["ms"],
              "stage_panel_ms_recorded": STAGE_PANEL_TWO_PASS_MS[name],
              "library_ms": by_case[name]["library_ms"]})
    # Where a complex call's time goes: each pass alone, through the
    # helpers the wrapper launches, beside the bytes one pass must move.
    from repro_torch.kernels import fft_radix2

    g = k.two_pass_geometry(nc)
    scratch, out = torch.empty_like(x), torch.empty_like(x)
    passes = {
        "columns": lambda: fft_radix2._column_pass(x, x.data_ptr(), scratch.data_ptr(), bc,
                                                   nc, False),
        "rows": lambda: fft_radix2._row_pass(x, scratch.data_ptr(), out.data_ptr(), bc, nc,
                                             False, 1.0),
    }
    pass_ms = {name: time_ms(fn) for name, fn in passes.items()}
    emit({"phase": "kernel", "kernel": "fft_two_pass", "case": "fft passes", "radix": 2,
          "shape": [bc, nc], "split": [g.n1, g.n2], "pass_ms": pass_ms,
          "one_pass_bound_ms": by_case["fft"]["bound_ms"]})
    del x, cases, scratch, out
    torch.cuda.empty_cache()
    worst = two_pass_every_length(torch, k, crandn, gen)
    long_rows = two_pass_long_rows(torch, k, card, crandn, gen, ptxas)
    for what in ("rel_err", "max_abs_err"):
        worst[what] = max(worst[what], *(c[what] for c in long_rows.values()))
    two_pass_past_2_31(torch, k, crandn)
    two_pass_beside_cluster(torch, k, card, crandn)
    main = by_case["fft"]
    errs = [r for c in by_case.values() for r in c["by_radix"].values()]
    return {"name": "fft_two_pass", "route": "cuda", "source": KERNELS["fft_two_pass"][0],
            "replaces": KERNELS["fft_two_pass"][1],
            "also_replaces": ["src/repro/kernels/fft_radix2.py:319",
                              "src/repro/kernels/fft_radix2.py:358"],
            "launches": 0, "max_abs_err": max(worst["max_abs_err"],
                                              *(r["max_abs_err"] for r in errs)),
            "rel_err": max(worst["rel_err"], *(r["rel_err"] for r in errs)), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "pass_ms": pass_ms, "shape": main["shape"], "by_case": by_case,
            "long_rows": long_rows}


def two_pass_every_length(torch, k, crandn, gen):
    """Every kind of fft_two_pass against its plain version at every row
    length the two passes serve (N = 2^15 ... 2^18: complex rows split 256
    x 128 to 512 x 512, real rows' halves 128 x 128 to 512 x 256), on 3 rows
    and at both of the phase's shapes, each call launching 2 (complex) or 3
    (real) times; returns the worst errors."""
    shapes = [(3, 2 ** p) for p in range(15, 19)] + [TWO_PASS_COMPLEX, TWO_PASS_REAL]
    worst = {"rel_err": 0.0, "max_abs_err": 0.0}
    for b, n in shapes:
        x = crandn(b, n)
        r = torch.randn(b, n, generator=gen, device="cuda")
        h = crandn(b, n // 2 + 1)
        calls = {"fft": (lambda: k.fft_fused(x, radix=2), lambda: k.fft_two_pass_plain(x), 2),
                 "ifft": (lambda: k.fft_fused(x, radix=2, inverse=True),
                          lambda: k.fft_two_pass_plain(x, inverse=True), 2),
                 "rfft": (lambda: k.rfft_fused(r, radix=2), lambda: k.rfft_two_pass_plain(r), 3),
                 "irfft": (lambda: k.irfft_fused(h, radix=2),
                           lambda: k.irfft_two_pass_plain(h), 3)}
        line = {"phase": "kernel", "kernel": "fft_two_pass", "case": "every length",
                "shape": [b, n], "rel_err": {}}
        for name, (kernel, plain, trips) in calls.items():
            before = k.LAUNCHES["fft_two_pass"]
            got = kernel()
            launched = k.LAUNCHES["fft_two_pass"] - before
            ref = plain()
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            line["rel_err"][name] = err
            worst["rel_err"] = max(worst["rel_err"], err)
            worst["max_abs_err"] = max(worst["max_abs_err"], max_abs(got, ref))
            del got, ref
            if not err <= TOL_KERNEL:
                raise AssertionError(f"fft_two_pass {name} {(b, n)}: rel err {err} > {TOL_KERNEL}")
            if launched != trips:
                raise AssertionError(f"fft_two_pass {name} {(b, n)}: {launched} launches, "
                                     f"not {trips}")
        emit(line)
        del x, r, h
        torch.cuda.empty_cache()
    return worst


def two_pass_long_rows(torch, k, card, crandn, gen, ptxas):
    """Every kind of fft_two_pass at every row length past the reference's
    envelope (N = 2^19 ... 2^24, LONG_ROW_VALUES values a case), at both
    radices (both engines run the two passes there): each call launches 2
    (complex) or 3 (real) times and nothing else, within TOL_KERNEL of its
    plain version and of torch.fft; one line a case with its time beside the
    one-trip bound, the two- or three-trip floor and the library's time, and
    ptxas's registers and spills of the case's instances (0 spilled, gated
    in two_pass_phase). Returns {case: line}."""
    out = {}
    for n in LONG_ROWS:
        b = LONG_ROW_VALUES // n
        g = k.two_pass_geometry(n)
        x = crandn(b, n)
        r = torch.randn(b, n, generator=gen, device="cuda")
        h = torch.fft.rfft(torch.randn(b, n, generator=gen, device="cuda"))  # Hermitian
        cases = {  # name: (kernel, plain, library, cost, trips, split)
            "fft": (lambda radix: k.fft_fused(x, radix=radix), lambda: k.fft_two_pass_plain(x),
                    lambda: torch.fft.fft(x), k.fft_cost(b, n), 2, g),
            "ifft": (lambda radix: k.fft_fused(x, radix=radix, inverse=True),
                     lambda: k.fft_two_pass_plain(x, inverse=True), lambda: torch.fft.ifft(x),
                     k.fft_cost(b, n), 2, g),
            "rfft": (lambda radix: k.rfft_fused(r, radix=radix), lambda: k.rfft_two_pass_plain(r),
                     lambda: torch.fft.rfft(r), k.rfft_cost(b, n), 3,
                     k.two_pass_geometry(n // 2)),
            "irfft": (lambda radix: k.irfft_fused(h, radix=radix),
                      lambda: k.irfft_two_pass_plain(h), lambda: torch.fft.irfft(h),
                      k.rfft_cost(b, n), 3, k.two_pass_geometry(n // 2)),
        }
        for name, (kernel, plain, library, cost, trips, split) in cases.items():
            want = plain()
            lib = library()
            line = {"phase": "kernel", "kernel": "fft_two_pass", "case": f"long {name}",
                    "shape": [b, n], "split": [split.n1, split.n2], "by_radix": {}}
            for radix in (2, 4):
                before = dict(k.LAUNCHES)
                got = kernel(radix)
                delta = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES
                         if k.LAUNCHES[kn] != before[kn]}
                torch.cuda.synchronize()
                line["by_radix"][str(radix)] = {
                    "launches_per_call": delta, "rel_err": rel_err(got, want),
                    "max_abs_err": max_abs(got, want), "rel_err_vs_library": rel_err(got, lib),
                    "ms": time_ms(lambda: kernel(radix))}
                del got
                if delta != {"fft_two_pass": trips}:
                    raise AssertionError(f"fft_two_pass long {name} {(b, n)} radix {radix}: "
                                         f"launches {delta}, not {trips} fft_two_pass")
            del want, lib
            bound_ms, bound_by = bound(card, cost)
            by_radix = line["by_radix"].values()
            line.update(
                rel_err=max(v["rel_err"] for v in by_radix),
                max_abs_err=max(v["max_abs_err"] for v in by_radix),
                rel_err_vs_library=max(v["rel_err_vs_library"] for v in by_radix),
                ms=line["by_radix"]["2"]["ms"],
                plain_ms=time_ms(plain, reps=2, batches=3),
                library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by,
                round_trips=trips, floor_ms=trips * bound_ms,
                ptxas={"columns": ptxas["columns"].get((split.n1.bit_length() - 1,
                                                        split.cols.bit_length() - 1)),
                       "rows": ptxas["rows"].get((split.n2.bit_length() - 1,
                                                  split.rows.bit_length() - 1))})
            line["ms_over_floor"] = line["ms"] / line["floor_ms"]
            emit(line)
            for what in ("rel_err", "rel_err_vs_library"):
                if not line[what] <= TOL_KERNEL:
                    raise AssertionError(f"fft_two_pass long {name} {(b, n)}: {what} "
                                         f"{line[what]} > {TOL_KERNEL}")
            out[f"{name} {n}"] = line
        del x, r, h
        torch.cuda.empty_cache()
    return out


def two_pass_past_2_31(torch, k, crandn):
    """A complex batch of more than 2^31 values (LONG_PAST_2_31: 129 rows of
    2^24) through fft_fused: the rows on either side of the 2^31st value
    held to torch.fft (2 launches)."""
    b, n = LONG_PAST_2_31
    x = crandn(b, n)
    before = k.LAUNCHES["fft_two_pass"]
    got = k.fft_fused(x, radix=2)
    launched = k.LAUNCHES["fft_two_pass"] - before
    rows = [0, b // 2, b - 2, b - 1]
    ref = torch.fft.fft(x[rows])
    line = {"phase": "kernel", "kernel": "fft_two_pass", "case": "past 2^31 values",
            "shape": [b, n], "values": b * n, "rows_checked": rows,
            "launches_per_call": launched, "rel_err_vs_library": rel_err(got[rows], ref)}
    del x, got, ref
    torch.cuda.empty_cache()
    emit(line)
    if launched != 2 or not line["rel_err_vs_library"] <= TOL_KERNEL:
        raise AssertionError(f"fft_two_pass past 2^31 values: {line}")


def two_pass_beside_cluster(torch, k, card, crandn):
    """The two passes (radix 2) and the cluster (radix 4) side by side on
    the complex rows both serve (N = 2^15 ... 2^18, 2^24 values a case),
    beside the one-trip bound and the two-trip floor: what ROADMAP's item
    on the planner's choice between them reads."""
    for n in (2 ** p for p in range(15, 19)):
        b = 2 ** 24 // n
        x = crandn(b, n)
        bound_ms, _ = bound(card, k.fft_cost(b, n))
        emit({"phase": "kernel", "kernel": "fft_two_pass", "case": "beside fft_cluster",
              "shape": [b, n], "two_pass_ms": time_ms(lambda: k.fft_fused(x, radix=2)),
              "cluster_ms": time_ms(lambda: k.fft_fused(x, radix=4)), "bound_ms": bound_ms,
              "two_trip_floor_ms": 2 * bound_ms, "library_ms": time_ms(lambda: torch.fft.fft(x))})
        del x
    torch.cuda.empty_cache()


def cluster_phase(torch, k, card: str):
    """fft_cluster (fft_fused, rfft_fused and irfft_fused at radix 4 on rows
    over one block: one cluster of CTAs a row, one HBM round trip) against
    its plain versions; returns its row. Each call must launch it once and
    nothing else. Each case's line also gives the instance (C, M), the
    clusters the card holds at once, ptxas's registers and spills, and the
    rate at which DSMEM carried the exchange (the values read from peers)
    if it took the whole kernel time (a floor of the network's rate)."""
    from repro_torch.kernels import _build

    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = torch.device("cuda")

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=gen, device=dev),
                             torch.randn(*shape, generator=gen, device=dev))

    bc, nc = TWO_PASS_COMPLEX
    br, nr = TWO_PASS_REAL
    x = crandn(bc, nc)
    cases = {  # name: (input, kernel, plain, library, cost, m, kind)
        "fft": (x, lambda z: k.fft_fused(z, radix=4), k.fft_cluster_plain, torch.fft.fft,
                k.fft_cost(bc, nc), nc, "fft"),
        "ifft": (x, lambda z: k.fft_fused(z, radix=4, inverse=True),
                 lambda z: k.fft_cluster_plain(z, inverse=True), torch.fft.ifft,
                 k.fft_cost(bc, nc), nc, "fft"),
        "rfft": (torch.randn(br, nr, generator=gen, device=dev),
                 lambda z: k.rfft_fused(z, radix=4), k.rfft_cluster_plain, torch.fft.rfft,
                 k.rfft_cost(br, nr), nr // 2, "rfft"),
        "irfft": (crandn(br, nr // 2 + 1), lambda z: k.irfft_fused(z, radix=4),
                  k.irfft_cluster_plain, torch.fft.irfft, k.rfft_cost(br, nr), nr // 2, "irfft"),
    }
    # The strip frames' rows, which rfft2/irfft2 hand the kernel: their own
    # instance (C 2, M 2^13), with its own load geometry.
    bs, ns = STRIP[0] * STRIP[1], STRIP[2]
    cases["rfft strip"] = (torch.randn(bs, ns, generator=gen, device=dev),
                           lambda z: k.rfft_fused(z, radix=4), k.rfft_cluster_plain,
                           torch.fft.rfft, k.rfft_cost(bs, ns), ns // 2, "rfft")
    cases["irfft strip"] = (crandn(bs, ns // 2 + 1), lambda z: k.irfft_fused(z, radix=4),
                            k.irfft_cluster_plain, torch.fft.irfft, k.rfft_cost(bs, ns),
                            ns // 2, "irfft")
    ptxas = ptxas_entries(_build.build_log(), "fft_cluster_kernel")
    by_case = {}
    for name, (z, kernel, plain, library, cost, m, kind) in cases.items():
        before = dict(k.LAUNCHES)
        got = kernel(z)
        delta = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES
                 if k.LAUNCHES[kn] != before[kn]}
        ref = plain(z)
        torch.cuda.synchronize()
        g = k.cluster_geometry(m)
        bound_ms, bound_by = bound(card, cost)
        line = {"phase": "kernel", "kernel": "fft_cluster", "case": name, "radix": 4,
                "shape": list(z.shape), "launches_per_call": delta,
                "rel_err": rel_err(got, ref), "max_abs_err": max_abs(got, ref),
                "ms": time_ms(lambda: kernel(z)),
                "plain_ms": time_ms(lambda: plain(z), reps=2, batches=3),
                "library_ms": time_ms(lambda: library(z)), "bound_ms": bound_ms,
                "bound_by": bound_by, "ctas": g.ctas, "values": g.values, "threads": g.threads,
                "smem_bytes": g.smem, "active_clusters": k.cluster_occupancy(m, kind),
                "ptxas": ptxas.get((g.ctas.bit_length() - 1, g.values.bit_length() - 1,
                                    k.CLUSTER_KINDS[kind])),
                "dsmem_bytes": 8 * z.shape[0] * m * (g.ctas - 1) // g.ctas}
        line["dsmem_rate_floor_gbps"] = line["dsmem_bytes"] / line["ms"] / 1e6
        del got, ref
        emit(line)
        if not line["rel_err"] <= TOL_KERNEL:
            raise AssertionError(f"fft_cluster {name}: rel err {line['rel_err']} > {TOL_KERNEL}")
        if delta != {"fft_cluster": 1}:
            raise AssertionError(f"fft_cluster {name}: launches {delta}, not one fft_cluster")
        by_case[name] = line
    del x, cases
    torch.cuda.empty_cache()
    main = by_case["fft"]
    return {"name": "fft_cluster", "route": "cuda", "source": KERNELS["fft_cluster"][0],
            "replaces": KERNELS["fft_cluster"][1],
            "also_replaces": ["src/repro/kernels/fft_radix2.py:319",
                              "src/repro/kernels/fft_radix2.py:358"],
            "launches": 0, "max_abs_err": max(c["max_abs_err"] for c in by_case.values()),
            "rel_err": max(c["rel_err"] for c in by_case.values()), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"],
            "by_case": {n: {kx: c[kx] for kx in ("shape", "ms", "plain_ms", "library_ms",
                                                  "bound_ms", "rel_err", "ctas", "values",
                                                  "active_clusters")}
                        for n, c in by_case.items()}}


def fid_source(torch, rows: int, n: int, seed: int):
    """FT-NMR free-induction decays, complex64 on the card: per row six
    damped complex exponentials (frequency, decay and amplitude from seeded
    numpy) plus complex noise of 0.01 from a seeded generator."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    freq, decay, amp = (torch.from_numpy(rng.uniform(lo, hi, (6, rows, 1))).to(dev)
                        for lo, hi in ((-0.45 * n, 0.45 * n), (2.0, 40.0), (0.2, 1.0)))
    t = torch.arange(n, dtype=torch.float64, device=dev) / n
    sig = torch.zeros(rows, n, dtype=torch.complex128, device=dev)
    for f, d, a in zip(freq, decay, amp):
        sig += a * torch.exp(-d * t) * torch.exp(2j * torch.pi * f * t)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.complex(torch.randn(rows, n, generator=gen, device=dev),
                          torch.randn(rows, n, generator=gen, device=dev))
    return sig.to(torch.complex64) + 0.01 * noise


def slstm_inputs(torch, dev, fan_in: int = 4, batch=None):
    """xlstm-350m sLSTM weights made as the reference's ``init_params``
    makes ``slstm_skel`` (normal, std = scale / sqrt(shape[0]), zero bias)
    from seeded numpy, carried across by ``slstm_weights_from_jax``; inputs
    x ~ 0.5 N(0, 1) and the gate pre-activations xg = x @ wx. ``fan_in``
    is wr's: 4 for one layer's skeleton, XLSTM_TRAIN_FAN_IN in the model's
    stacked init; ``batch`` by default XLSTM's."""
    import numpy as np

    from repro_torch.kernels.slstm_scan import slstm_state, slstm_weights_from_jax

    b, l, d = batch or XLSTM["batch"], XLSTM["seq"], XLSTM["d"]
    rng = np.random.default_rng(14)
    p = {"wx": (rng.standard_normal((d, 4 * d)) / np.sqrt(d)).astype(np.float32),
         "wr": (rng.standard_normal((4, d // 4, d)) * 0.5 / np.sqrt(fan_in)).astype(np.float32),
         "bias": np.zeros(4 * d, np.float32)}
    w = slstm_weights_from_jax(p, device=dev)
    x = torch.from_numpy((rng.standard_normal((b, l, d)) * 0.5).astype(np.float32)).to(dev)
    state = slstm_state(b, d, device=dev)
    return x @ w["wx"], w, (state["c"], state["n"], state["h"], state["m"])


def llama_qkv(torch, dev, gen):
    """q (24, S, 128) and k/v repeated from 8 kv heads to the 24 query heads."""
    h, kvh, s, d = LLAMA["heads"], LLAMA["kv_heads"], LLAMA["seq"], LLAMA["head_dim"]
    q = torch.randn(h, s, d, generator=gen, device=dev)
    kk = torch.randn(kvh, s, d, generator=gen, device=dev).repeat_interleave(h // kvh, 0)
    v = torch.randn(kvh, s, d, generator=gen, device=dev).repeat_interleave(h // kvh, 0)
    return q, kk, v


def slstm_plain64(torch, w, seg, start):
    """The plain step loop in float64 over ``seg`` (B, L, 4D) from the
    state ``start``: (hs, final state)."""
    from repro_torch.kernels.slstm_scan import slstm_step

    w64 = {"wr": w["wr"].double(), "bias": w["bias"].double()}
    d = seg.shape[-1] // 4
    st = dict(zip("cnhm", (x.double() for x in start)))
    out = []
    for t in range(seg.shape[1]):
        st = slstm_step(w64, st, seg[:, t].double(), d)
        out.append(st["h"])
    return torch.stack(out, 1), tuple(st[nm] for nm in "cnhm")


def slstm_windows(torch, xg, w, state, hs):
    """slstm_scan against its plain version over every SLSTM_WINDOW-step
    window of ``xg``, each from the plain version's state where the window
    starts (the recurrence is chaotic at the reference's init, see
    model_kernel_phase); ``hs`` is the full-length launch, which must equal
    the first window bit for bit. Returns the worst relative errors by
    output (hs and the final c, n, h, m), the plain version's own worst
    distance from float64, and the worst absolute error."""
    from repro_torch.kernels.slstm_scan import slstm_scan, slstm_scan_plain

    errs = dict.fromkeys(("hs", "c", "n", "h", "m"), 0.0)
    plain_errs = dict(errs)
    abs_err = 0.0
    start = state
    for t0 in range(0, xg.shape[1], SLSTM_WINDOW):
        seg = xg[:, t0:t0 + SLSTM_WINDOW].contiguous()
        kh, kf = slstm_scan(seg, w["wr"], w["bias"], *start, chunk=seg.shape[1])
        ph, pf = slstm_scan_plain(seg, w["wr"], w["bias"], *start)
        qh, qf = slstm_plain64(torch, w, seg, start)
        if t0 == 0 and not torch.equal(kh, hs[:, :seg.shape[1]]):
            raise AssertionError("slstm_scan: the full-length launch and its first window differ")
        for nm, got, ref, ref64 in zip(errs, (kh, *kf), (ph, *pf), (qh, *qf)):
            errs[nm] = max(errs[nm], rel_err(got, ref))
            plain_errs[nm] = max(plain_errs[nm], rel_err(ref, ref64))
            abs_err = max(abs_err, max_abs(got, ref))
        start = pf
    torch.cuda.synchronize()
    return errs, plain_errs, abs_err


def check_slstm_windows(what: str, errs, plain_errs, finite: bool, h_max: float) -> None:
    """The window gate: every window within TOL_SLSTM of the plain version,
    the plain version itself within TOL_SLSTM of float64 (else the window is
    too long to hold the kernel to), hs finite with |h| <= 1."""
    if not finite or not h_max <= 1.0 or not max(errs.values()) <= TOL_SLSTM:
        raise AssertionError(f"{what}: window rel errs {errs} (tolerance {TOL_SLSTM}), "
                             f"finite {finite}, max |h| {h_max}")
    if not max(plain_errs.values()) <= TOL_SLSTM:
        raise AssertionError(f"{what}: the plain version leaves float64 by {plain_errs} "
                             f"within {SLSTM_WINDOW} steps; the window is too long")


def slstm_work(xg, w):
    """The ``Cost`` of slstm_scan on these inputs
    (``kernels.slstm_scan.scan_cost``: xg, wr, bias and the four initial
    states read once, hs and the four final states written once; the
    recurrent product, 2 D^2 a step and batch row). The products run on the
    tensor cores in double, whose dense rate on an H100 SXM (67 TFLOP/s) is
    the float32 CUDA-core rate the bound takes."""
    from repro_torch.kernels.slstm_scan import scan_cost

    b, l, d4 = xg.shape
    return scan_cost(b, l, d4 // 4)


def rel_or_abs(got, ref) -> float:
    """rel_err where ref has a nonzero value, else the largest |got|."""
    return rel_err(got, ref) if bool(ref.abs().max() > 0) else float(got.abs().max())


def slstm_saving_windows(torch, xg, w, state, hs, final, saved):
    """The stores of the full-length launch of the saving slstm_scan over
    every SLSTM_WINDOW-step window: hs, gates, cs, ns and ms of the window
    (and the final state, in the last) against the plain saving forward
    from the state the launch stored before the window (the initial state
    for the first). Returns the worst relative errors by output, the plain
    version's own worst distance from float64, and the worst absolute
    error."""
    from repro_torch.kernels.slstm_scan import _scan_saving_plain

    names = ("hs", "gates", "cs", "ns", "ms", "c", "n", "h", "m")
    errs = dict.fromkeys(names, 0.0)
    plain_errs = dict(errs)
    abs_err = 0.0
    gates, cs, ns, ms = saved
    l = xg.shape[1]
    for t0 in range(0, l, SLSTM_WINDOW):
        t1 = min(l, t0 + SLSTM_WINDOW)
        seg = xg[:, t0:t1]
        start = state if t0 == 0 else tuple(x[:, t0 - 1] for x in (cs, ns, hs, ms))
        ph, pf, ps = _scan_saving_plain(seg, w["wr"], w["bias"], *start)
        qh, qf, qs = _scan_saving_plain(seg.double(), w["wr"], w["bias"], *start)
        got = [hs[:, t0:t1], *(x[:, t0:t1] for x in saved)]
        ref, ref64 = [ph, *ps], [qh, *qs]
        if t1 == l:
            got, ref, ref64 = got + list(final), ref + list(pf), ref64 + list(qf)
        for nm, a, r, q in zip(names, got, ref, ref64):
            errs[nm] = max(errs[nm], rel_or_abs(a, r))
            plain_errs[nm] = max(plain_errs[nm], rel_or_abs(r.double(), q))
            abs_err = max(abs_err, max_abs(a, r))
    torch.cuda.synchronize()
    return errs, plain_errs, abs_err


def slstm_bwd_windows(torch, saved, w, state, dhs, dfinal, dxg):
    """slstm_scan_bwd against its plain version over every SLSTM_WINDOW-step
    window of the saved forward, from the last window back: each window
    starts from the saved state before it (the initial state for the
    first) and takes the cotangents of hs in it and, at its end, the
    plain version's initial-state gradients of the window after (the final
    states' cotangents for the last). ``dxg`` is the full-length launch,
    whose last window must equal the per-window launch bit for bit.
    Returns the worst relative errors by output (dxg, dc0, dn0, dh0, dm0),
    the plain version's own worst distance from float64, and the worst
    absolute error."""
    from repro_torch.kernels.slstm_scan import slstm_scan_bwd, slstm_scan_bwd_plain

    names = ("dxg", "dc0", "dn0", "dh0", "dm0")
    errs = dict.fromkeys(names, 0.0)
    plain_errs = dict(errs)
    abs_err = 0.0
    l = dhs.shape[1]
    end = dfinal
    for t0 in reversed(range(0, l, SLSTM_WINDOW)):
        t1 = min(l, t0 + SLSTM_WINDOW)
        seg = tuple(x[:, t0:t1].contiguous() for x in saved)
        start = state if t0 == 0 else tuple(x[:, t0 - 1].contiguous() for x in saved[1:])
        args = (w["wr"], *start, dhs[:, t0:t1].contiguous())
        kx, kg = slstm_scan_bwd(seg, *args, end)
        px, pg = slstm_scan_bwd_plain(seg, *args, end)
        qx, qg = slstm_scan_bwd_plain(tuple(x.double() for x in seg),
                                      *(x.double() for x in args), tuple(x.double() for x in end))
        if t1 == l and not torch.equal(kx, dxg[:, t0:t1]):
            raise AssertionError("slstm_scan_bwd: the full-length launch and its last window "
                                 "differ")
        for nm, got, ref, ref64 in zip(names, (kx, *kg), (px, *pg), (qx, *qg)):
            errs[nm] = max(errs[nm], rel_or_abs(got, ref))
            plain_errs[nm] = max(plain_errs[nm], rel_or_abs(ref.double(), ref64))
            abs_err = max(abs_err, max_abs(got, ref))
        end = pg
    torch.cuda.synchronize()
    return errs, plain_errs, abs_err


def slstm_bwd_work(saved, dhs, w):
    """The ``Cost`` of slstm_scan_bwd on these inputs
    (``kernels.slstm_scan.scan_bwd_cost``: the saved gates and c, n, m,
    dhs, wr, the three initial and four final-state cotangents read once,
    dxg and the four initial-state gradients written once; the transposed
    product, 2 D^2 a step and batch row)."""
    from repro_torch.kernels.slstm_scan import scan_bwd_cost

    b, l, d4 = saved[0].shape
    return scan_bwd_cost(b, l, d4 // 4)


def slstm_bwd_case(torch, card: str, batch=None):
    """slstm_scan_bwd at xlstm-350m's width (batch, 4096, 1024), by default
    XLSTM's batch, from the saving forward on inputs at the model's init
    scale, with Gaussian cotangents of hs and of the four final states.
    The saving forward's hs and final state must equal the forward
    instance's bit for bit, and its stores hold over windows
    (slstm_saving_windows); the backward holds over windows
    (slstm_bwd_windows), its full-length launch finite, timed beside its
    plain version, its bound and the grid's L barriers alone, with
    ptxas's registers and spills of each route. Prints one line and
    returns it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm_scan import (
        ROUTES,
        slstm_barriers,
        slstm_bwd_blocks_per_sm,
        slstm_bwd_card_grid,
        slstm_scan,
        slstm_scan_bwd,
        slstm_scan_bwd_plain,
        slstm_scan_saving,
    )

    dev = torch.device("cuda")
    xg, w, state = slstm_inputs(torch, dev, fan_in=XLSTM_TRAIN_FAN_IN, batch=batch)
    b, l, d = xg.shape[0], XLSTM["seq"], XLSTM["d"]
    gen = torch.Generator(device=dev).manual_seed(15)
    dhs = torch.randn(b, l, d, generator=gen, device=dev)
    dfinal = tuple(torch.randn(b, d, generator=gen, device=dev) for _ in range(4))
    hs, final, saved = slstm_scan_saving(xg, w["wr"], w["bias"], *state)
    fwd_hs, fwd_final = slstm_scan(xg, w["wr"], w["bias"], *state)
    same = bool(torch.equal(hs, fwd_hs)) and all(bool(torch.equal(a, r))
                                                 for a, r in zip(final, fwd_final))
    del fwd_hs, fwd_final
    save_finite = all(bool(torch.isfinite(x).all()) for x in (hs, *final, *saved))
    h_max = float(hs.abs().max())
    save_errs, save_plain_errs, save_abs = slstm_saving_windows(torch, xg, w, state, hs, final,
                                                                saved)
    start = (state[0], state[1], state[3])
    dxg, grads = slstm_scan_bwd(saved, w["wr"], *start, dhs, dfinal)
    errs, plain_errs, abs_err = slstm_bwd_windows(torch, saved, w, start, dhs, dfinal, dxg)
    finite = bool(torch.isfinite(dxg).all()) and all(bool(torch.isfinite(g).all())
                                                     for g in grads)
    plain_x, plain_g = slstm_scan_bwd_plain(saved, w["wr"], *start, dhs, dfinal)
    grid = slstm_bwd_card_grid(d, b, dev)
    ptxas = {ROUTES[key[0]]: v for key, v in
             ptxas_entries(_build.build_log(), "21slstm_scan_bwd_kernel").items()}
    steps_back = {str(t): float(dxg[:, l - t].abs().max()) for t in (1, 16, 256, 1024, l)
                  if t <= l}
    line = {"phase": "kernel", "kernel": "slstm_scan_bwd", "shape": [b, l, 4 * d],
            "wr_fan_in": XLSTM_TRAIN_FAN_IN, "window": SLSTM_WINDOW, "rel_err": errs,
            "plain_vs_float64_rel_err": plain_errs, "max_abs_err": abs_err, "finite": finite,
            "saving_equals_forward": same, "saving_finite": save_finite, "max_abs_h": h_max,
            "saving_rel_err": save_errs,
            "saving_plain_vs_float64_rel_err": save_plain_errs, "saving_max_abs_err": save_abs,
            "full_run_vs_plain_rel_err": max(rel_or_abs(dxg, plain_x),
                                             *(rel_or_abs(a, r) for a, r in zip(grads, plain_g))),
            "max_abs_dxg_steps_back": steps_back,
            "ms": time_ms(lambda: slstm_scan_bwd(saved, w["wr"], *start, dhs, dfinal),
                          reps=5, batches=3),
            "plain_ms": time_ms(lambda: slstm_scan_bwd_plain(saved, w["wr"], *start, dhs,
                                                             dfinal), reps=1, batches=3),
            "forward_saving_ms": time_ms(lambda: slstm_scan_saving(xg, w["wr"], w["bias"],
                                                                   *state), reps=5, batches=3),
            "barrier_floor_ms": time_ms(lambda: slstm_barriers(b, d, l), reps=5, batches=3),
            "ctas": grid.ctas, "units": grid.units, "threads": grid.threads,
            "rows": grid.rows, "groups": grid.groups, "route": grid.route,
            "smem_bytes": grid.smem_bytes, "blocks_per_sm": slstm_bwd_blocks_per_sm(grid),
            "ptxas": ptxas, "card": card}
    line["ms_per_step"] = line["ms"] / l
    cost = slstm_bwd_work(saved, dhs, w)
    line.update(cost._asdict())
    line["bound_ms"], line["bound_by"] = bound(card, cost)
    emit(line)
    del xg, hs, saved, dhs, dxg, plain_x
    torch.cuda.empty_cache()
    spilled = {r: e for r, e in ptxas.items() if e.get("spill_stores", 1) + e.get("spill_loads", 1)}
    if len(ptxas) != len(ROUTES) or spilled:
        raise AssertionError(f"slstm_scan_bwd: ptxas {ptxas}; spilled {spilled}")
    if not same:
        raise AssertionError("slstm_scan: the saving instance's hs or final state differs from "
                             "the forward instance's")
    check_slstm_windows("slstm_scan (saving)", save_errs, save_plain_errs, save_finite, h_max)
    if not finite or not max(errs.values()) <= TOL_SLSTM:
        raise AssertionError(f"slstm_scan_bwd: window rel errs {errs} (tolerance {TOL_SLSTM}), "
                             f"finite {finite}")
    if not max(plain_errs.values()) <= TOL_SLSTM:
        raise AssertionError(f"slstm_scan_bwd: the plain version leaves float64 by "
                             f"{plain_errs} within {SLSTM_WINDOW} steps")
    return line


def model_kernel_phase(torch, card: str):
    """butterfly_stage, flash_attention_fwd and slstm_scan against their
    plain versions at full width; returns the per-kernel rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import butterfly as bf
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import _build
    from repro_torch.kernels._launch import Cost
    from repro_torch.kernels.slstm_scan import (
        ROUTES,
        slstm_barriers,
        slstm_blocks_per_sm,
        slstm_card_grid,
        slstm_scan,
        slstm_scan_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}

    def row(name, err, rel, ms, plain_ms, cost, library_ms, flop_rate=PEAK_FLOPS_FP32,
            **extra):
        bound_ms, bound_by = bound(card, cost, flop_rate)
        rows[name] = {"name": name, "route": "cuda", "source": KERNELS[name][0],
                      "replaces": KERNELS[name][1], "launches": 0, "max_abs_err": err,
                      "rel_err": rel, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms, **extra}

    # butterfly_stage: one stage of (8192, 2048), every stage.
    b, n = STAGED
    re = torch.randn(b, n, generator=gen, device=dev)
    im = torch.randn(b, n, generator=gen, device=dev)
    stages = []
    for stage in range(n.bit_length() - 1):
        got = bf.butterfly_stage(re, im, stage=stage)
        ref = bf.butterfly_stage_plain(re, im, stage=stage)
        torch.cuda.synchronize()
        err = max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1]))
        rel = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
        line = {"phase": "kernel", "kernel": "butterfly_stage", "stage": stage,
                "shape": [b, n], "rel_err": rel, "max_abs_err": err,
                "ms": time_ms(lambda: bf.butterfly_stage(re, im, stage=stage)),
                "plain_ms": time_ms(lambda: bf.butterfly_stage_plain(re, im, stage=stage),
                                    reps=2, batches=3)}
        emit(line)
        if not rel <= TOL_KERNEL:
            raise AssertionError(f"butterfly_stage stage {stage}: rel err {rel} > {TOL_KERNEL}")
        stages.append(line)
    row("butterfly_stage", max(x["max_abs_err"] for x in stages),
        max(x["rel_err"] for x in stages), statistics.mean(x["ms"] for x in stages),
        statistics.mean(x["plain_ms"] for x in stages), bf.stage_cost(b, n), None,
        shape=[b, n], per="stage", ms_by_stage=[x["ms"] for x in stages])
    del re, im, got, ref
    torch.cuda.empty_cache()

    # flash_attention_fwd: llama3.2-3b causal, mixtral-8x22b sliding window.
    s, d = MIXTRAL["seq"], MIXTRAL["head_dim"]
    pos = torch.arange(s, device=dev)
    swa = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - MIXTRAL["window"])
    cases = [
        ("llama3.2-3b", *llama_qkv(torch, dev, gen), None,
         lambda q, kk, v: F.scaled_dot_product_attention(q[None], kk[None], v[None],
                                                         is_causal=True)),
        ("mixtral-8x22b swa",
         *(torch.randn(MIXTRAL["heads"], s, d, generator=gen, device=dev) for _ in range(3)),
         MIXTRAL["window"],
         lambda q, kk, v: F.scaled_dot_product_attention(q[None], kk[None], v[None],
                                                         attn_mask=swa)),
    ]
    by_case, costs = {}, {}
    for label, q, kk, v, window, library in cases:
        got = fa.flash_attention_fwd(q, kk, v, causal=True, window=window)
        ref = fa.flash_attention_plain(q, kk, v, causal=True, window=window)
        torch.cuda.synchronize()
        bh, sq, dh = q.shape
        costs[label] = cost = fa.fwd_cost(bh, sq, kk.shape[1], dh, v.shape[2], causal=True,
                                          window=window)
        line = {"phase": "kernel", "kernel": "flash_attention_fwd", "case": label,
                "shape": list(q.shape), "window": window, "rel_err": rel_err(got, ref),
                "max_abs_err": max_abs(got, ref),
                "ms": time_ms(lambda: fa.flash_attention_fwd(q, kk, v, causal=True,
                                                             window=window), reps=5, batches=3),
                "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, kk, v, causal=True,
                                                                     window=window),
                                    reps=2, batches=3),
                "library_ms": time_ms(lambda: library(q, kk, v), reps=5, batches=3),
                **cost._asdict()}
        # The kernel's products run on the tensor cores, split into three
        # TF32 products; the CUDA-core float32 figure stays beside it.
        line["bound_ms"], line["bound_by"] = bound(card, cost, split_tf32_rate(card))
        line["simt_bound_ms"] = bound(card, cost)[0]
        emit(line)
        if not line["rel_err"] <= TOL_KERNEL:
            raise AssertionError(f"flash_attention_fwd {label}: rel err {line['rel_err']}")
        by_case[label] = line
        del got, ref
    main = by_case["llama3.2-3b"]
    emit({"phase": "kernel", "kernel": "flash_attention_fwd", "head_dim": d,
          "blocks_per_sm": fa.flash_blocks_per_sm(d, d), "smem_bytes": fa.flash_smem_bytes(d, d),
          "threads": fa.THREADS})
    row("flash_attention_fwd", max(x["max_abs_err"] for x in by_case.values()),
        max(x["rel_err"] for x in by_case.values()), main["ms"], main["plain_ms"],
        costs["llama3.2-3b"], main["library_ms"], split_tf32_rate(card),
        shape=main["shape"],
        by_case={lb: {kx: x[kx] for kx in ("shape", "window", "rel_err", "ms", "plain_ms",
                                             "library_ms", "bound_ms", "bound_by")}
                 for lb, x in by_case.items()})
    del cases, q, kk, v, swa
    torch.cuda.empty_cache()

    # slstm_scan at xlstm-350m width. At the reference's init the
    # recurrence is chaotic: a rounding difference doubles about every 8
    # steps, so after ~100 steps two float32 runs (the plain version and
    # float64 too) disagree at O(1). The kernel is therefore held to the
    # plain version over windows of SLSTM_WINDOW steps that both start from
    # the plain version's state, covering all 4096 steps and each window's
    # final state; the window is short enough that the plain version itself
    # stays within the tolerance of a float64 run (checked below). The
    # full-length launch is checked for finiteness, |h| <= 1, and against
    # the first window bit for bit; past that window, at the steps of
    # SLSTM_DIVERGENCE_STEPS, it may leave the plain version by at most
    # SLSTM_DIVERGENCE_FACTOR times the plain version's own distance from
    # float64 at the same step.
    xg, w, state = slstm_inputs(torch, dev)
    b, l, d = XLSTM["batch"], XLSTM["seq"], XLSTM["d"]
    hs, final = slstm_scan(xg, w["wr"], w["bias"], *state)
    ref_hs, _ = slstm_scan_plain(xg, w["wr"], w["bias"], *state)
    hs64, _ = slstm_plain64(torch, w, xg, state)
    divergence = {str(t): {"kernel_vs_plain": max_abs(hs[:, t - 1], ref_hs[:, t - 1]),
                           "plain_vs_float64": max_abs(ref_hs[:, t - 1].double(),
                                                       hs64[:, t - 1]),
                           "kernel_vs_float64": max_abs(hs[:, t - 1].double(),
                                                        hs64[:, t - 1])}
                  for t in (1, 4, 16, 32, 64, 128, 256, 1024, 4096) if t <= l}
    del ref_hs, hs64
    errs, plain_errs, abs_err = slstm_windows(torch, xg, w, state, hs)
    finite = bool(torch.isfinite(hs).all()) and all(bool(torch.isfinite(x).all())
                                                    for x in final)
    h_max = float(hs.abs().max())
    grid = slstm_card_grid(d, b, dev)
    line = {"phase": "kernel", "kernel": "slstm_scan", "shape": list(xg.shape),
            "window": SLSTM_WINDOW, "rel_err": errs, "plain_vs_float64_rel_err": plain_errs,
            "max_abs_err": abs_err, "finite": finite, "max_abs_h": h_max,
            "divergence_full_run": divergence,
            "ms": time_ms(lambda: slstm_scan(xg, w["wr"], w["bias"], *state),
                          reps=5, batches=3),
            "plain_ms": time_ms(lambda: slstm_scan_plain(xg, w["wr"], w["bias"], *state),
                                reps=1, batches=3),
            # the same grid running L barriers and nothing else
            "barrier_floor_ms": time_ms(lambda: slstm_barriers(b, d, l), reps=5, batches=3),
            "ctas": grid.ctas, "units": grid.units, "threads": grid.threads,
            "rows": grid.rows, "groups": grid.groups, "route": grid.route,
            "smem_bytes": grid.smem_bytes, "blocks_per_sm": slstm_blocks_per_sm(grid),
            "ptxas": {ROUTES[key[0]] + (" saving" if key[1] else ""): v for key, v in
                      ptxas_entries(_build.build_log(), "17slstm_scan_kernel").items()}}
    line["ms_per_step"] = line["ms"] / l
    line["barrier_floor_ms_per_step"] = line["barrier_floor_ms"] / l
    emit(line)
    check_slstm_windows("slstm_scan", errs, plain_errs, finite, h_max)
    for t in SLSTM_DIVERGENCE_STEPS:
        at = divergence[str(t)]
        if not at["kernel_vs_plain"] <= SLSTM_DIVERGENCE_FACTOR * at["plain_vs_float64"]:
            raise AssertionError(f"slstm_scan: at step {t} of the full launch the kernel leaves "
                                 f"the plain version by {at['kernel_vs_plain']}, more than "
                                 f"{SLSTM_DIVERGENCE_FACTOR} x the plain version's "
                                 f"{at['plain_vs_float64']} from float64")
    row("slstm_scan", abs_err, max(errs.values()), line["ms"], line["plain_ms"],
        slstm_work(xg, w), None, shape=list(xg.shape), window=SLSTM_WINDOW,
        rel_err_by_output=errs,
        grid_route=line["route"],
        **{key: line[key] for key in ("ms_per_step", "ctas", "units",
                                      "barrier_floor_ms", "barrier_floor_ms_per_step")})
    del xg, final
    torch.cuda.empty_cache()

    # slstm_scan_bwd at the same width, from the saving forward.
    back = slstm_bwd_case(torch, card)
    row("slstm_scan_bwd", back["max_abs_err"], max(back["rel_err"].values()), back["ms"],
        back["plain_ms"], Cost(flops=back["flops"], bytes=back["bytes"]), None,
        shape=back["shape"],
        window=SLSTM_WINDOW, rel_err_by_output=back["rel_err"], grid_route=back["route"],
        **{key: back[key] for key in ("ms_per_step", "ctas", "units", "barrier_floor_ms",
                                      "forward_saving_ms")})
    return rows, hs


def path_phase(torch, card: str, slstm_hs):
    """The other entry points of ``repro_torch.kernels`` through the counts;
    returns the launch counts of the run."""
    from repro_torch.kernels import (
        fft_kernel,
        fft_staged,
        flash_attention_fwd,
        hbm_traffic_model,
        mha_reference,
        slstm_scan,
    )
    from repro_torch.kernels._launch import LAUNCHES, reset_launches

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.complex(torch.randn(*STAGED, generator=gen, device=dev),
                      torch.randn(*STAGED, generator=gen, device=dev))
    q, kk, v = llama_qkv(torch, dev, gen)
    xg, w, state = slstm_inputs(torch, dev)
    torch.cuda.synchronize()

    reset_launches()
    spec = fft_staged(x)
    staged_launches = LAUNCHES["butterfly_stage"]
    attn = flash_attention_fwd(q, kk, v, causal=True)
    hs, _ = slstm_scan(xg, w["wr"], w["bias"], *state)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    if staged_launches != STAGED[1].bit_length() - 1:
        raise AssertionError(f"fft_staged launched butterfly_stage {staged_launches} times")
    for name in ("flash_attention_fwd", "slstm_scan"):
        if launches[name] != 1:
            raise AssertionError(f"{name} launched {launches[name]} times, not once")
    fft_err = rel_err(spec, torch.fft.fft(x))
    attn_ok = tuple(attn.shape) == tuple(q.shape) and bool(torch.isfinite(attn).all())
    attn_err = rel_err(attn, mha_reference(q, kk, v, causal=True))
    same = bool(torch.equal(hs, slstm_hs))
    emit({"phase": "path", "launches": launches, "fft_staged_rel_err": fft_err,
          "flash_rel_err_vs_mha_reference": attn_err, "flash_finite": attn_ok,
          "slstm_repeats_kernel_phase": same})
    if not fft_err <= TOL_REQUEST:
        raise AssertionError(f"fft_staged: rel err {fft_err} > {TOL_REQUEST}")
    if not attn_ok or not attn_err <= TOL_KERNEL:
        raise AssertionError(f"flash_attention_fwd: rel err {attn_err}, finite {attn_ok}")
    if not same:
        raise AssertionError("slstm_scan gave another result on the same inputs")
    del attn, q, kk, v, hs, xg
    torch.cuda.empty_cache()

    b, n = STAGED
    staged_ms = time_ms(lambda: fft_staged(x))
    fused_ms = {r: time_ms(lambda: fft_kernel(x, radix=r)) for r in (2, 4)}
    model = {str(f): hbm_traffic_model(b, n, f) for f in (True, False)}
    emit({"phase": "path", "staged_vs_fused": {
        "shape": [b, n], "card": card, "fft_staged_ms": staged_ms,
        "fft_kernel_r2_ms": fused_ms[2], "fft_kernel_r4_ms": fused_ms[4],
        "measured_ratio_r2": staged_ms / fused_ms[2], "measured_ratio_r4": staged_ms / fused_ms[4],
        "hbm_traffic_model_bytes": {"fused": model["True"], "staged": model["False"]},
        "modelled_ratio": model["False"] / model["True"]}})
    return launches


def request_phase(torch, k, xfft, resolve_call):
    """Requests through xfft; returns the launch counts of the whole run."""
    dev = torch.device("cuda")

    def engine(kind, shape, direction="fwd", dtype="complex64"):
        return resolve_call(kind, tuple(shape), dev, dtype=dtype, direction=direction).variant

    def request(name, fn, expect, plan, forbid=()):
        before = dict(k.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES}
        for kn in expect:
            if delta[kn] < 1:
                raise AssertionError(f"request {name}: {kn} was not launched ({delta})")
        for kn in forbid:
            if delta[kn]:
                raise AssertionError(f"request {name}: {kn} was launched ({delta})")
        return out, {"phase": "request", "name": name, "engine": plan, "launches": delta,
                     "ms": ms}

    def check(line, err, tol, what="rel_err"):
        line[what] = err
        if not err <= tol:
            raise AssertionError(f"request {line['name']}: {what} {err} > {tol}")

    def check_peaks(line, got, ref, full=True):
        agree = bool(torch.equal(peaks(got, full), peaks(ref, full)))
        line["peaks_agree"] = agree
        if not agree:
            raise AssertionError(f"request {line['name']}: dominant bins disagree")

    k.reset_launches()
    # 128x128 serving frames: the whole frame in one block, complex and real.
    frames = torch.from_numpy(frame_source(0, 512, 128, 128)).to(dev)
    spec, line = request("fft2 (512,128,128)", lambda: xfft.fft2(frames), ["fft2_fused"],
                         engine("fft2d", frames.shape), forbid=[COLUMNS])
    ref = torch.fft.fft2(frames)
    check(line, rel_err(spec, ref), TOL_REQUEST)
    check_peaks(line, spec, ref)
    emit(line)
    back, line = request("ifft2 (512,128,128)", lambda: xfft.ifft2(spec), ["fft2_fused"],
                         engine("fft2d", spec.shape, "inv"))
    check(line, rel_err(back, torch.fft.ifft2(spec)), TOL_REQUEST)
    check(line, max_abs(back.real, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    out, line = request("fft2 norm=ortho (512,128,128)",
                        lambda: xfft.fft2(frames, norm="ortho"), ["fft2_fused"],
                        engine("fft2d", frames.shape))
    check(line, rel_err(out, torch.fft.fft2(frames, norm="ortho")), TOL_REQUEST)
    emit(line)
    turned = frames.permute(1, 2, 0)  # (128, 128, 512), transform axes (0, 1)
    out, line = request("fft2 axes=(0,1) (128,128,512)",
                        lambda: xfft.fft2(turned, axes=(0, 1)), ["fft2_fused"],
                        engine("fft2d", frames.shape))
    check(line, rel_err(out, torch.fft.fft2(turned, dim=(0, 1))), TOL_REQUEST)
    emit(line)
    half, line = request("rfft2 (512,128,128)", lambda: xfft.rfft2(frames), ["rfft2_fused"],
                         engine("rfft2d", frames.shape, dtype="float32"), forbid=[COLUMNS])
    ref = torch.fft.rfft2(frames)
    check(line, rel_err(half, ref), TOL_REQUEST)
    check_peaks(line, half, ref, full=False)
    emit(line)
    back, line = request("irfft2 (512,128,128)", lambda: xfft.irfft2(half), ["irfft2_fused"],
                         engine("rfft2d", frames.shape, "inv", "float32"), forbid=[COLUMNS])
    check(line, rel_err(back, torch.fft.irfft2(half)), TOL_REQUEST)
    check(line, max_abs(back, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del frames, spec, back, out, turned, half, ref

    # 1024x1024 holograms: fft_fused rows, then fft2_columns in place.
    frames = torch.from_numpy(frame_source(1, 16, 1024, 1024)).to(dev)
    spec, line = request("fft2 (16,1024,1024)", lambda: xfft.fft2(frames),
                         ["fft_fused", COLUMNS], engine("fft2d", frames.shape))
    ref = torch.fft.fft2(frames)
    check(line, rel_err(spec, ref), TOL_REQUEST)
    check_peaks(line, spec, ref)
    emit(line)
    back, line = request("ifft2 (16,1024,1024)", lambda: xfft.ifft2(spec),
                         ["fft_fused", COLUMNS], engine("fft2d", spec.shape, "inv"))
    check(line, rel_err(back, torch.fft.ifft2(spec)), TOL_REQUEST)
    check(line, max_abs(back.real, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del frames, spec, back, ref

    # 512x512 CT frames, real input: over one block, so rfft_fused rows,
    # then fft2_columns on the half spectra (no fft_fused on the columns).
    frames = torch.from_numpy(frame_source(2, 32, 512, 512)).to(dev)
    half, line = request("rfft2 (32,512,512)", lambda: xfft.rfft2(frames),
                         ["rfft_fused", COLUMNS],
                         engine("rfft2d", frames.shape, dtype="float32"), forbid=["fft_fused"])
    ref = torch.fft.rfft2(frames)
    check(line, rel_err(half, ref), TOL_REQUEST)
    check_peaks(line, half, ref, full=False)
    emit(line)
    back, line = request("irfft2 (32,512,512)", lambda: xfft.irfft2(half),
                         [COLUMNS, "irfft_fused"],
                         engine("rfft2d", frames.shape, "inv", "float32"), forbid=["fft_fused"])
    check(line, rel_err(back, torch.fft.irfft2(half)), TOL_REQUEST)
    check(line, max_abs(back, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del frames, half, back, ref

    # 1D rows: 64 chirp frames of 512x512 laid out as 8192 rows of 2048.
    rows = torch.from_numpy(frame_source(3, 64, 512, 512)).to(dev).reshape(8192, 2048)
    crow = torch.complex(rows, rows.flip(0))
    out, line = request("fft (8192,2048)", lambda: xfft.fft(crow), ["fft_fused"],
                        engine("fft1d", crow.shape))
    check(line, rel_err(out, torch.fft.fft(crow)), TOL_REQUEST)
    emit(line)
    half, line = request("rfft (8192,2048)", lambda: xfft.rfft(rows), ["rfft_fused"],
                         engine("rfft1d", rows.shape, dtype="float32"))
    check(line, rel_err(half, torch.fft.rfft(rows)), TOL_REQUEST)
    emit(line)
    back, line = request("irfft (8192,1025)", lambda: xfft.irfft(half), ["irfft_fused"],
                         engine("rfft1d", rows.shape, "inv", "float32"))
    check(line, rel_err(back, torch.fft.irfft(half)), TOL_REQUEST)
    check(line, max_abs(back, rows) / float(rows.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del rows, crow, out, half, back

    # Rows over one block: each request plans fused_r4 and launches the
    # cluster kernel, never the two-pass kernels; one request scoped to the
    # radix-2 engine keeps those on a path.
    def long_rows(name, fn, kind, shape, direction="fwd", dtype="complex64", also=()):
        plan = engine(kind, shape, direction, dtype)
        if plan != "fused_r4":
            raise AssertionError(f"request {name}: planned {plan}, not fused_r4")
        return request(name, fn, ["fft_cluster", *also], plan, forbid=["fft_two_pass"])

    fid = fid_source(torch, *TWO_PASS_COMPLEX, seed=4)
    spec, line = long_rows("fft (64,262144)", lambda: xfft.fft(fid), "fft1d", fid.shape)
    check(line, rel_err(spec, torch.fft.fft(fid)), TOL_REQUEST)
    emit(line)
    back, line = long_rows("ifft (64,262144)", lambda: xfft.ifft(spec), "fft1d", fid.shape,
                           "inv")
    check(line, rel_err(back, torch.fft.ifft(spec)), TOL_REQUEST)
    check(line, max_abs(back, fid) / float(fid.abs().max()), TOL_ROUND_TRIP, "round_trip_err")
    emit(line)
    with xfft.config(variant="fused"):
        back, line = request("ifft variant=fused (64,262144)", lambda: xfft.ifft(spec),
                             ["fft_two_pass"], engine("fft1d", fid.shape, "inv"),
                             forbid=["fft_cluster"])
    check(line, rel_err(back, torch.fft.ifft(spec)), TOL_REQUEST)
    check(line, max_abs(back, fid) / float(fid.abs().max()), TOL_ROUND_TRIP, "round_trip_err")
    emit(line)
    del fid, spec, back
    lines = fid_source(torch, *TWO_PASS_REAL, seed=5).real.contiguous()
    half, line = long_rows("rfft (256,65536)", lambda: xfft.rfft(lines), "rfft1d",
                           lines.shape, dtype="float32")
    check(line, rel_err(half, torch.fft.rfft(lines)), TOL_REQUEST)
    emit(line)
    back, line = long_rows("irfft (256,32769)", lambda: xfft.irfft(half), "rfft1d",
                           lines.shape, "inv", "float32")
    check(line, rel_err(back, torch.fft.irfft(half)), TOL_REQUEST)
    check(line, max_abs(back, lines) / float(lines.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del lines, half, back
    # Past the reference's envelope (2^18 < N <= 2^24): each request plans
    # the fused engines (a tie that fused_r4 takes) and launches the two
    # passes, never the cluster.
    def past_2_18(name, fn, kind, shape, direction="fwd", dtype="complex64", also=()):
        plan = engine(kind, shape, direction, dtype)
        if plan != "fused_r4":
            raise AssertionError(f"request {name}: planned {plan}, not fused_r4")
        return request(name, fn, ["fft_two_pass", *also], plan, forbid=["fft_cluster"])

    fid = fid_source(torch, *LONG_FID, seed=6)
    spec, line = past_2_18(f"fft {LONG_FID}", lambda: xfft.fft(fid), "fft1d", fid.shape)
    check(line, rel_err(spec, torch.fft.fft(fid)), TOL_REQUEST)
    emit(line)
    del fid, spec
    records = fid_source(torch, *LONG_RECORDS, seed=7).real.contiguous()
    half, line = past_2_18(f"rfft {LONG_RECORDS}", lambda: xfft.rfft(records), "rfft1d",
                           records.shape, dtype="float32")
    check(line, rel_err(half, torch.fft.rfft(records)), TOL_REQUEST)
    emit(line)
    del records, half
    strips = torch.from_numpy(frame_source(5, *LONG_STRIP)).to(dev)
    cstrips = strips.to(torch.complex64)
    spec, line = past_2_18(f"fft2 {LONG_STRIP}", lambda: xfft.fft2(cstrips), "fft2d",
                           strips.shape, also=[COLUMNS])
    check(line, rel_err(spec, torch.fft.fft2(cstrips)), TOL_REQUEST)
    emit(line)
    half = torch.fft.rfft2(strips)
    back, line = past_2_18(f"irfft2 {LONG_STRIP}", lambda: xfft.irfft2(half), "rfft2d",
                           strips.shape, "inv", "float32", also=[COLUMNS])
    check(line, rel_err(back, torch.fft.irfft2(half)), TOL_REQUEST)
    check(line, max_abs(back, strips) / float(strips.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del strips, cstrips, spec, half, back
    frames = torch.from_numpy(frame_source(4, *STRIP)).to(dev)
    half, line = long_rows("rfft2 (8,512,32768)", lambda: xfft.rfft2(frames), "rfft2d",
                           frames.shape, dtype="float32", also=[COLUMNS])
    check(line, rel_err(half, torch.fft.rfft2(frames)), TOL_REQUEST)
    emit(line)
    back, line = long_rows("irfft2 (8,512,32768)", lambda: xfft.irfft2(half), "rfft2d",
                           frames.shape, "inv", "float32", also=[COLUMNS])
    check(line, rel_err(back, torch.fft.irfft2(half)), TOL_REQUEST)
    check(line, max_abs(back, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del frames, half, back
    torch.cuda.empty_cache()
    return dict(k.LAUNCHES)


class KernelTap:
    """Watches the port's calls during the spectral and imaging phase: every
    call of a fused wrapper made through ``repro_torch.kernels.ops`` is
    recorded with its arguments (so that its kernel can be timed alone on
    the same inputs afterwards), and every call of a plain schedule of
    ``repro_torch.core.fft1d`` is counted (none may run on the card)."""

    def __init__(self):
        from repro_torch.core import fft1d
        from repro_torch.kernels import ops

        self.recorded, self.recording, self.plain_calls = [], False, 0
        self._saved = [(ops, n, getattr(ops, n)) for n in FUSED_WRAPPERS]
        self._saved += [(fft1d, n, getattr(fft1d, n)) for n in PLAIN_SCHEDULES]
        for module, name, fn in self._saved:
            setattr(module, name, (self._plain if module is fft1d else self._fused)(name, fn))

    def _fused(self, name, fn):
        def wrapper(*args, **kw):
            if self.recording:
                # An in-place call (fft2_columns on the row pass's output) is
                # recorded with a copy of its input; a replay writes a new
                # tensor.
                rec = (args[0].clone(), *args[1:]) if kw.get("out") is not None else args
                self.recorded.append((name, fn, rec, {a: v for a, v in kw.items() if a != "out"}))
            return fn(*args, **kw)
        return wrapper

    def _plain(self, name, fn):
        def wrapper(*args, **kw):
            self.plain_calls += 1
            return fn(*args, **kw)
        return wrapper

    def restore(self):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def band_limited_frames(n: int, count: int, seed: int):
    """``count`` distinct (n, n) band-limited frames from
    ``repro_torch.imaging.band_limited_frame`` (numpy, made once)."""
    import numpy as np

    from repro_torch.imaging import band_limited_frame

    return np.stack([band_limited_frame(n, seed=seed + i) for i in range(count)])


def padded_conv(torch, image, kernel, mode: str = "same"):
    """The yardstick of the convolutions: a linear convolution through one
    size-exact padded ``torch.fft.rfft2``, cropped to scipy's ``mode``."""
    h, w = image.shape[-2:]
    kh, kw = kernel.shape[-2:]
    s = (h + kh - 1, w + kw - 1)
    full = torch.fft.irfft2(torch.fft.rfft2(image, s=s) * torch.fft.rfft2(kernel, s=s), s=s)
    if mode == "full":
        return full
    top, left = (kh - 1) // 2, (kw - 1) // 2
    return full[..., top:top + h, left:left + w]


def plain_twin(k, name: str, x, kw):
    """What the fused wrapper ``name`` runs on a CPU tensor, run on the
    card's ``x``: its plain version where a row fits one block, else the
    cluster's (radix 4) or the two passes' (radix 2). Returns the name of
    the kernel row the wrapper's launch belongs to and the plain output."""
    if name in FRAME_KERNELS or name == COLUMNS:
        return name, getattr(k, f"{name}_plain")(x, **kw)
    n = 2 * (x.shape[-1] - 1) if name == "irfft_fused" else x.shape[-1]
    if k.fft_fits_smem(n, real=name != "fft_fused"):
        return name, getattr(k, f"{name}_plain")(x, **kw)
    base = name[:-len("_fused")]
    if kw.get("radix", 2) == 4:
        rest = {a: v for a, v in kw.items() if a != "radix"}
        return "fft_cluster", getattr(k, f"{base}_cluster_plain")(x, **rest)
    return "fft_two_pass", getattr(k, f"{base}_two_pass_plain")(x, **kw)


class TappedCalls:
    """Runs the calls of the ``imaging`` and ``mri`` phases: each call once
    with the launch counts read around it and its fused-wrapper calls
    recorded by ``tap``, then timed. Each of its kernel launches is run
    again on the same inputs, held against its plain twin there at
    ``TOL_KERNEL`` (the worst error joins its row of the ``kernels`` line)
    and timed alone. The launches of every call add to ``total``."""

    def __init__(self, torch, k, tap, rows, phase: str):
        self.torch, self.k, self.tap, self.rows, self.phase = torch, k, tap, rows, phase
        self.total = dict.fromkeys(k.LAUNCHES, 0)

    def __call__(self, name, fn, shape, plan, expect, forbid=(), reps=10, batches=5):
        """Run ``fn`` once with the counts read around it, then time it and
        each kernel launch it made; returns its output and its line."""
        torch, k, tap = self.torch, self.k, self.tap
        before, plain = dict(k.LAUNCHES), tap.plain_calls
        tap.recording, tap.recorded = True, []
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        tap.recording = False
        delta = {n: k.LAUNCHES[n] - before[n] for n in k.LAUNCHES if k.LAUNCHES[n] != before[n]}
        for n in expect:
            if delta.get(n, 0) < 1:
                raise AssertionError(f"{name}: {n} was not launched ({delta})")
        for n in forbid:
            if delta.get(n, 0):
                raise AssertionError(f"{name}: {n} was launched ({delta})")
        if tap.plain_calls != plain:
            raise AssertionError(f"{name}: ran a plain schedule on the card")
        for n, c in delta.items():
            self.total[n] += c
        launched, tap.recorded = tap.recorded, []
        groups = {}  # launches of one wrapper, shape and options: timed once
        for kname, kfn, args, kw in launched:
            key = (kname, tuple(args[0].shape), tuple(sorted(kw.items())))
            got = kfn(*args, **kw)
            row, ref = plain_twin(self.k, kname, args[0], kw)
            err = float((got - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-30)
            del got, ref
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"{name}: {kname} {key[1:]} against its plain twin: "
                                     f"rel err {rel} > {TOL_KERNEL}")
            self.rows[row]["max_abs_err"] = max(self.rows[row]["max_abs_err"], err)
            self.rows[row]["rel_err"] = max(self.rows[row]["rel_err"], rel)
            if key in groups:
                one = groups[key]
                one["count"] += 1
                one["rel_err"] = max(one["rel_err"], rel)
                one["max_abs_err"] = max(one["max_abs_err"], err)
                continue
            one = {"kernel": kname, "shape": list(args[0].shape), **kw, "count": 1,
                   "rel_err": rel, "max_abs_err": err,
                   "ms": time_ms(lambda: kfn(*args, **kw))}
            if self.rows[kname]["shape"] == one["shape"]:
                one["kernel_phase_ms"] = self.rows[kname]["ms"]
            groups[key] = one
        del launched
        kernels = list(groups.values())
        ms = time_ms(fn, reps, batches)
        kernel_ms = sum(kn["ms"] * kn["count"] for kn in kernels)
        return out, {"phase": self.phase, "call": name, "shape": list(shape), "plan": plan,
                     "ms": ms, "kernel_ms": kernel_ms, "kernel_share": kernel_ms / ms,
                     "kernels": kernels, "launches": delta}


def check(line, err, tol, what="rel_err"):
    """Record ``err`` on the line as ``what``; raise when it passes ``tol``."""
    line[what] = err
    if not err <= tol:
        raise AssertionError(f"{line['call']}: {what} {err} > {tol}")


def imaging_phase(torch, k, xfft, resolve_call, rows):
    """``repro_torch.core.spectral`` and ``repro_torch.imaging`` through
    their public functions on the card, each call held to a ``torch.fft``
    yardstick; returns the launches of the phase's checked calls."""
    tap = KernelTap()
    try:
        call = TappedCalls(torch, k, tap, rows, "imaging")
        _imaging_calls(torch, xfft, resolve_call, call)
        return call.total
    finally:
        tap.restore()


def _imaging_calls(torch, xfft, resolve_call, call):
    import numpy as np

    from repro_torch import imaging
    from repro_torch.core import spectral
    from repro_torch.imaging.registration import register_logpolar

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.default_rng(23)

    def engine(kind, shape, direction="fwd", dtype="complex64"):
        return resolve_call(kind, tuple(shape), dev, dtype=dtype, direction=direction).variant

    whole_frame_real = list(ROW_KERNELS) + ["fft2_fused", COLUMNS]
    whole_frame_complex = list(ROW_KERNELS) + ["rfft2_fused", "irfft2_fused", COLUMNS]
    composed = list(FRAME_KERNELS) + ["fft_two_pass", "fft_cluster"]
    rows_only = ["fft_two_pass", "fft_cluster", COLUMNS]

    # Registration on 128x128 frames: planted whole-pixel shifts come back
    # exactly, subpixel ones within 1/upsample + 0.05 px.
    frames = torch.from_numpy(band_limited_frames(REG[-1], REG[0], seed=0)).to(dev)
    whole = torch.from_numpy(rng.integers(-60, 61, (REG[0], 2)).astype(np.float32)).to(dev)
    sub = torch.from_numpy(rng.uniform(-20, 20, (REG[0], 2)).astype(np.float32)).to(dev)
    plan = {"rfft2d": engine("rfft2d", REG, dtype="float32"),
            "rfft2d inv": engine("rfft2d", REG, "inv", "float32")}
    fy = torch.fft.fftfreq(REG[1], device=dev)[:, None]
    fx = torch.fft.rfftfreq(REG[2], device=dev)[None, :]

    def shifted(x, s):
        ramp = torch.exp(-2j * math.pi * (fy * s[:, 0, None, None] + fx * s[:, 1, None, None]))
        return torch.fft.irfft2(torch.fft.rfft2(x) * ramp, s=x.shape[-2:])

    for label, shifts in (("whole", whole), ("sub", sub)):
        mov, line = call(f"apply_shift {label}-pixel", lambda: imaging.apply_shift(frames, shifts),
                         REG, plan, FRAME_KERNELS[1:], whole_frame_real)
        check(line, rel_err(mov, shifted(frames, shifts)), TOL_REQUEST)
        emit(line)
        upsample = 1 if label == "whole" else UPSAMPLE
        got, line = call(f"register_phase_correlation {label}-pixel upsample={upsample}",
                         lambda: imaging.register_phase_correlation(frames, mov, upsample),
                         REG, plan, FRAME_KERNELS[1:], whole_frame_real)
        err = float((got + shifts).abs().max())
        check(line, err, 0.0 if upsample == 1 else 1 / UPSAMPLE + 0.05, "max_shift_err_px")
        emit(line)
    cframes = torch.complex(frames, frames.roll(1, 0))
    cplan = {"fft2d": engine("fft2d", REG), "fft2d inv": engine("fft2d", REG, "inv")}
    cmov, line = call("apply_shift complex whole-pixel",
                      lambda: imaging.apply_shift(cframes, whole), REG, cplan, ["fft2_fused"],
                      whole_frame_complex)
    check(line, rel_err(cmov, torch.complex(shifted(frames, whole),
                                            shifted(frames.roll(1, 0), whole))), TOL_REQUEST)
    emit(line)
    got, line = call("register_phase_correlation complex whole-pixel",
                     lambda: imaging.register_phase_correlation(cframes, cmov), REG, cplan,
                     ["fft2_fused"], whole_frame_complex)
    check(line, float((got + whole).abs().max()), 0.0, "max_shift_err_px")
    emit(line)
    corr, line = call("correlate2", lambda: spectral.correlate2(frames, mov), REG, plan,
                      FRAME_KERNELS[1:], whole_frame_real)
    check(line, rel_err(corr, torch.fft.irfft2(torch.fft.rfft2(frames)
                                               * torch.fft.rfft2(mov).conj())), TOL_REQUEST)
    emit(line)
    del frames, cframes, mov, cmov, corr

    # Periodic-plus-smooth on 512x512 CT frames (over one block: composed).
    i, j = np.mgrid[0:CT[1], 0:CT[2]]
    ct = torch.from_numpy((0.05 * i / 8 + 0.03 * j / 8 + 0.2 * rng.standard_normal(CT)
                           ).astype(np.float32)).to(dev)
    plan = {"rfft2d": engine("rfft2d", CT, dtype="float32"),
            "rfft2d inv": engine("rfft2d", CT, "inv", "float32"),
            "rfft1d": engine("rfft1d", (CT[0], CT[2]), dtype="float32")}
    (periodic, smooth), line = call("psd_decompose", lambda: imaging.psd_decompose(ct), CT, plan,
                                    ["rfft_fused", COLUMNS, "irfft_fused"],
                                    composed + ["fft_fused"])
    check(line, max_abs(periodic + smooth, ct) / float(ct.abs().max()), TOL_ROUND_TRIP,
          "sum_err")
    emit(line)
    spec, line = call("fft2_psd", lambda: imaging.fft2_psd(ct), CT, plan,
                      ["rfft_fused", COLUMNS], composed + ["fft_fused"])
    check(line, rel_err(spec, torch.fft.fft2(periodic)), TOL_REQUEST)
    emit(line)
    del ct, periodic, smooth, spec

    # Centered k-space on (8 coils, 4 slices) of 256x256 MRI frames.
    img = torch.complex(torch.randn(*MRI, generator=gen, device=dev),
                        torch.randn(*MRI, generator=gen, device=dev))
    plan = {"fft2d": engine("fft2d", MRI), "fft2d inv": engine("fft2d", MRI, "inv")}
    ks, line = call("image_to_kspace", lambda: imaging.image_to_kspace(img), MRI, plan,
                    ["fft_fused", COLUMNS], composed)
    dims = (-2, -1)
    check(line, rel_err(ks, torch.fft.fftshift(torch.fft.fft2(
        torch.fft.ifftshift(img, dim=dims), norm="ortho"), dim=dims)), TOL_REQUEST)
    check(line, abs(float(ks.norm() / img.norm()) - 1.0), TOL_ROUND_TRIP, "parseval_err")
    emit(line)
    back, line = call("kspace_to_image", lambda: imaging.kspace_to_image(ks), MRI, plan,
                      ["fft_fused", COLUMNS], composed)
    check(line, max_abs(back, img) / float(img.abs().max()), TOL_ROUND_TRIP, "round_trip_err")
    emit(line)
    del img, ks, back

    # Overlap-save on holograms, and a matched filter over a wide scene: the
    # tile the planner picks, one batched rfft2 and one irfft2 a direction.
    holo = torch.from_numpy(frame_source(5, *HOLO)).to(dev)
    kern = torch.randn(HOLO_KERNEL, HOLO_KERNEL, generator=gen, device=dev) / HOLO_KERNEL
    key = (HOLO[1], HOLO[2], HOLO_KERNEL, HOLO_KERNEL)
    tiled = resolve_call("oaconv2d", key, dev, dtype="float32")
    plan = {"tile": list(tiled.tile), "variant": tiled.variant}
    out, line = call("oaconvolve2", lambda: imaging.oaconvolve2(holo, kern), HOLO, plan,
                     FRAME_KERNELS[1:], whole_frame_real)
    check(line, rel_err(out, padded_conv(torch, holo, kern)), TOL_ROUND_TRIP)
    emit(line)
    del holo, out
    scene = 0.5 * torch.randn(SCENE, SCENE, generator=gen, device=dev)
    template = torch.randint(0, 2, (TEMPLATE, TEMPLATE), generator=gen, device=dev) * 2.0 - 1
    at = (SCENE * 3 // 10 + 5, SCENE * 2 // 3 + 3)  # (1233, 2733)
    scene[at[0]:at[0] + TEMPLATE, at[1]:at[1] + TEMPLATE] += template
    tiled = resolve_call("oaconv2d", (SCENE, SCENE, TEMPLATE, TEMPLATE), dev, dtype="float32")
    plan = {"tile": list(tiled.tile), "variant": tiled.variant}
    corr, line = call("matched_filter2", lambda: imaging.matched_filter2(scene, template),
                      (SCENE, SCENE), plan, FRAME_KERNELS[1:], whole_frame_real)
    check(line, rel_err(corr, padded_conv(torch, scene, template.flip(-2, -1))), TOL_ROUND_TRIP)
    peak = divmod(int(corr.argmax()), SCENE)
    line["peak"], line["planted_at"] = list(peak), list(at)
    check(line, float(max(abs(peak[a] - at[a] - TEMPLATE // 2) for a in (0, 1))), 0.0,
          "peak_offset_px")
    emit(line)
    del scene, corr

    # Rotation and scale of a 256x256 frame turned a quarter turn.
    ref = torch.from_numpy(band_limited_frames(LOGPOLAR, 1, seed=900)[0]).to(dev)
    plan = {"rfft2d": engine("rfft2d", (LOGPOLAR, LOGPOLAR), dtype="float32")}
    (angle, scale), line = call("register_logpolar",
                                lambda: register_logpolar(ref, torch.rot90(ref)),
                                (LOGPOLAR, LOGPOLAR), plan,
                                ["rfft_fused", COLUMNS, "irfft_fused"], composed + ["fft_fused"])
    line["angle"], line["scale"] = angle, scale
    check(line, abs(abs(angle) - math.pi / 2), 0.03, "angle_err")
    check(line, abs(scale - 1.0), 0.02, "scale_err")
    emit(line)

    # The LM-facing entries of core/spectral.
    x = torch.randn(*MIX, generator=gen, device=dev)
    want = torch.fft.fft2(x).real
    plan = {"fft2d": engine("fft2d", MIX)}
    mix, line = call("fourier_mixing", lambda: spectral.fourier_mixing(x), MIX, plan,
                     ["fft_fused", COLUMNS], composed)
    check(line, rel_err(mix, want), TOL_REQUEST)
    emit(line)
    plan = {"rfft1d": engine("rfft1d", MIX, dtype="float32"),
            "fft1d": engine("fft1d", (MIX[0], MIX[2] // 2 + 1, MIX[1]))}
    mix, line = call("fourier_mixing variant=rfft",
                     lambda: spectral.fourier_mixing(x, variant="rfft"), MIX, plan,
                     ["rfft_fused", "fft_fused"], composed + [COLUMNS])
    check(line, rel_err(mix, want), TOL_REQUEST)
    emit(line)
    del x, want, mix
    x = torch.randn(*CONV, generator=gen, device=dev)
    kern = torch.randn(*CONV[1:], generator=gen, device=dev) / math.sqrt(CONV[1])
    n = 2 * CONV[1]
    plan = {"rfft1d": engine("rfft1d", (CONV[0], CONV[2], n), dtype="float32")}
    y, line = call("fftconv", lambda: spectral.fftconv(x, kern), CONV, plan,
                   ["rfft_fused", "irfft_fused"], rows_only)
    want = torch.fft.irfft(torch.fft.rfft(x.transpose(-1, -2), n)
                           * torch.fft.rfft(kern.transpose(-1, -2), n), n)[..., :CONV[1]]
    check(line, rel_err(y, want.transpose(-1, -2)), TOL_ROUND_TRIP)
    emit(line)
    del x, kern, y, want
    t = torch.arange(AUDIO[1], device=dev) / 16000.0
    tones = torch.tensor([220.0, 440.0, 1000.0, 3000.0], device=dev)
    audio = (torch.sin(2 * math.pi * tones[:, None, None] * t).sum(0)
             * torch.rand(AUDIO[0], 1, generator=gen, device=dev)
             + 0.1 * torch.randn(*AUDIO, generator=gen, device=dev))
    windows = audio.unfold(-1, 512, 256) * torch.from_numpy(spectral._hann(512)).to(dev)
    plan = {"fft1d": engine("fft1d", windows.shape)}
    spec, line = call("stft", lambda: spectral.stft(audio), AUDIO, plan, ["fft_fused"],
                      ["fft2_fused"] + rows_only)
    want = torch.fft.fft(windows.to(torch.complex64))[..., :257]
    check(line, rel_err(spec, want), TOL_REQUEST)
    emit(line)
    mel, line = call("log_mel", lambda: spectral.log_mel(audio), AUDIO, plan, ["fft_fused"],
                     ["fft2_fused"] + rows_only)
    fb = torch.from_numpy(spectral._mel_filterbank(257, 80)).to(dev)
    power = torch.clamp(torch.einsum("...tf,mf->...tm", want.abs() ** 2, fb), min=1e-10)
    # Held in linear power, the layer's linear output: a mel band 1e-4 of the
    # loudest one carries float32's error of the loud bins into its log.
    check(line, rel_err(10.0 ** mel.double(), power), TOL_REQUEST, "mel_power_rel_err")
    line["max_abs_err_log10"] = max_abs(mel, torch.log10(power))
    emit(line)
    torch.cuda.empty_cache()


def fourier_shift(torch, x, shifts):
    """The yardstick of ``apply_shift``: each frame of ``x`` (or ``x``
    itself, for one (H, W) frame) moved by its (dy, dx) through
    ``torch.fft``."""
    fy = torch.fft.fftfreq(x.shape[-2], device=x.device)[:, None]
    fx = torch.fft.fftfreq(x.shape[-1], device=x.device)[None, :]
    ramp = torch.exp(-2j * math.pi * (fy * shifts[:, 0, None, None]
                                      + fx * shifts[:, 1, None, None]))
    return torch.fft.ifft2(torch.fft.fft2(x) * ramp)


def centered(torch, x, inverse=False):
    """The centered ortho 2D transform of MRI through ``torch.fft``."""
    dims = (-2, -1)
    fn = torch.fft.ifft2 if inverse else torch.fft.fft2
    return torch.fft.fftshift(fn(torch.fft.ifftshift(x, dim=dims), norm="ortho"), dim=dims)


def torch_cg_sense(torch, kspace, smaps, mask, iters: int, lam: float = 0.0):
    """The yardstick of ``recon_cg_sense``: the same CG in complex128 on
    ``torch.fft``."""
    s = smaps.to(torch.complex128)
    m = mask.to(torch.float64)

    def normal(x):
        return (s.conj() * centered(torch, centered(torch, s * x[..., None, :, :]) * m,
                                    inverse=True)).sum(-3) + lam * x

    def dot(a, b):
        return (a.conj() * b).sum((-2, -1)).real

    b = (s.conj() * centered(torch, kspace.to(torch.complex128) * m, inverse=True)).sum(-3)
    x, r, p = torch.zeros_like(b), b, b
    rs = dot(r, r)
    for _ in range(iters):
        q = normal(p)
        alpha = rs / dot(p, q).clamp(min=1e-30)
        x = x + alpha[..., None, None] * p
        r = r - alpha[..., None, None] * q
        rs_new = dot(r, r)
        p = r + (rs_new / rs.clamp(min=1e-30))[..., None, None] * p
        rs = rs_new
    return x


def mri_phase(torch, k, xfft, resolve_call, rows):
    """``repro_torch.mri`` through its public functions on the card at a
    clinical size, each call held to a ``torch.fft`` form of its definition
    and to the reference's gates, then the double-precision sub-phase;
    returns the launches of the phase's checked calls."""
    tap = KernelTap()
    try:
        call = TappedCalls(torch, k, tap, rows, "mri")
        _mri_calls(torch, xfft, resolve_call, call)
        _mri_double(torch, k, xfft, resolve_call, tap)
        _obs_cost(torch, xfft, resolve_call)
        return call.total
    finally:
        tap.restore()


def _mri_calls(torch, xfft, resolve_call, call):
    import numpy as np

    from repro_torch import mri, obs

    dev = torch.device("cuda")
    b, c, h, w = RECON
    phantom = mri.shepp_logan(h)
    studies = np.stack([phantom, phantom[::-1], phantom[:, ::-1], np.roll(phantom, h // 16, 0)])
    img = torch.from_numpy(studies[:b].copy()).to(dev)                 # (4, 256, 256)
    smaps = torch.from_numpy(mri.birdcage_maps(c, h)).to(dev)           # (16, 256, 256)
    uniform = torch.from_numpy(mri.uniform_mask((h, w), ACCEL, calib=CALIB)).to(dev)
    vd_np = mri.variable_density_mask((h, w), ACCEL, calib=CALIB, seed=24)
    vd = torch.from_numpy(vd_np).to(dev)
    plan = {"fft2d": resolve_call("fft2d", RECON, dev).variant,
            "fft2d inv": resolve_call("fft2d", RECON, dev, direction="inv").variant}
    composed = list(FRAME_KERNELS) + ["fft_two_pass", "fft_cluster", "rfft_fused", "irfft_fused"]
    masks_line = {"uniform_R": mri.acceleration(uniform),
                  "variable_density_R": mri.acceleration(vd_np), "calib_rows": CALIB}

    ks, line = call("sense_forward", lambda: mri.sense_forward(img, smaps, uniform), RECON, plan,
                    ["fft_fused", COLUMNS], composed)
    check(line, rel_err(ks, centered(torch, smaps * img[:, None]) * uniform), TOL_REQUEST)
    line["masks"] = masks_line
    emit(line)
    zf, line = call("sense_adjoint", lambda: mri.sense_adjoint(ks, smaps, uniform), RECON, plan,
                    ["fft_fused", COLUMNS], composed)
    want = (smaps.conj() * centered(torch, ks * uniform, inverse=True)).sum(-3)
    check(line, rel_err(zf, want), TOL_REQUEST)
    emit(line)
    del want

    # ESPIRiT-lite maps from the variable-density acquisition's calibration
    # block: on the object, held to the torch.fft definition and to the truth.
    kvd = mri.sense_forward(img, smaps, vd)
    est, line = call("estimate_sensitivities", lambda: mri.estimate_sensitivities(
        kvd, calib=CALIB, mask=vd_np), RECON, plan, ["fft_fused", COLUMNS], composed)
    win = np.zeros(h, np.float32)
    win[(h - CALIB) // 2:(h + CALIB) // 2] = np.hanning(CALIB + 2)[1:-1]
    low = centered(torch, kvd * torch.from_numpy(np.outer(win, win)).to(dev), inverse=True)
    want = low / (low.abs().square().sum(-3, keepdim=True).sqrt() + 1e-6)
    support = (img > 0.1)[:, None].expand(est.shape)
    check(line, rel_err(est[support], want[support]), TOL_ROUND_TRIP, "rel_err_on_object")
    check(line, float((est - smaps).abs()[support].mean()), 0.06, "mean_err_to_truth")
    emit(line)
    del low, want

    def ratios(recon, blind):
        """Each study's NRMSE over its baseline's."""
        return [mri.nrmse(recon[i].to(torch.complex64), img[i]) / mri.nrmse(blind[i], img[i])
                for i in range(recon.shape[0])]

    def gate(line, recon, blind, margin, what):
        """Every study's NRMSE under ``margin`` times its baseline's."""
        line[f"nrmse_over_{what}"] = ratios(recon, blind)
        check(line, max(line[f"nrmse_over_{what}"]), margin, f"max_nrmse_over_{what}")

    # CG-SENSE, uniform R 4: the iteration's time, its kernels' share, and
    # the normal operator alone back to back (what the host sync and the CG
    # updates add to it), against a float64 torch.fft CG of the same steps.
    with obs.capture() as trace:
        x, line = call("recon_cg_sense uniform", lambda: mri.recon_cg_sense(
            ks, smaps, uniform, iters=CG_ITERS), RECON, plan, ["fft_fused", COLUMNS], composed,
            3, 3)
    line["iters"] = CG_ITERS
    line["ms_per_iter"] = line["ms"] / CG_ITERS
    line["normal_op_ms"] = time_ms(lambda: mri.sense_adjoint(
        mri.sense_forward(x, smaps, uniform), smaps, uniform), 3, 3)
    line["cg_loop_ms_per_iter"] = time_ms(lambda: mri.cg_normal(
        lambda p: p, zf, iters=CG_ITERS), 3, 3) / CG_ITERS
    line["residuals"] = [e["residual"] for e in trace.select("mri.cg.iter")[:CG_ITERS]]
    gate(line, x, zf, 0.5, "zero_filled")
    check(line, rel_err(x, torch_cg_sense(torch, ks, smaps, uniform, CG_ITERS)), TOL_CG_F64,
          "rel_err_vs_float64_cg")
    emit(line)
    # Variable density with the true maps: the reference test's mask call
    # (R 4, its default 16 calibration rows, seed 0) at 256^2, held to its
    # margin, 0.6 of zero-filled. The ratios of the float64 torch.fft CG on
    # the same inputs are printed beside, and those of both on the seed-24,
    # 24-row mask of the estimated-maps call below (recorded, not gated).
    vd_ref_np = mri.variable_density_mask((h, w), ACCEL, seed=0)
    vd_ref = torch.from_numpy(vd_ref_np).to(dev)
    kref = mri.sense_forward(img, smaps, vd_ref)
    x, line = call("recon_cg_sense variable-density", lambda: mri.recon_cg_sense(
        kref, smaps, vd_ref, iters=CG_ITERS), RECON, plan, ["fft_fused", COLUMNS], composed,
        3, 3)
    line["iters"] = CG_ITERS
    line["ms_per_iter"] = line["ms"] / CG_ITERS
    line["mask"] = {"R": mri.acceleration(vd_ref_np), "seed": 0, "calib_rows": 16}
    zf_ref = mri.recon_zero_filled(kref, smaps, vd_ref)
    want = torch_cg_sense(torch, kref, smaps, vd_ref, CG_ITERS)
    line["float64_cg_nrmse_over_zero_filled"] = ratios(want, zf_ref)
    gate(line, x, zf_ref, 0.6, "zero_filled")
    check(line, rel_err(x, want), TOL_CG_F64, "rel_err_vs_float64_cg")
    line["seed24_mask"] = {
        "R": mri.acceleration(vd_np), "seed": 24, "calib_rows": CALIB,
        "nrmse_over_zero_filled": ratios(mri.recon_cg_sense(kvd, smaps, vd, iters=CG_ITERS),
                                         mri.recon_zero_filled(kvd, smaps, vd)),
        "float64_cg_nrmse_over_zero_filled": ratios(
            torch_cg_sense(torch, kvd, smaps, vd, CG_ITERS),
            mri.recon_zero_filled(kvd, smaps, vd))}
    emit(line)
    del kref, zf_ref, want
    # The same acquisition with estimated maps, Tikhonov 1e-3 as in the
    # reference's estimated-maps test. That test's margin (0.75 of
    # zero-filled) is set at R 2, and the reference holds estimated maps at
    # no R ~4 margin; so here the ratios are recorded, CG must improve on
    # zero-filled, and the image is held to a float64 CG.
    x, line = call("recon_cg_sense variable-density estimated maps", lambda: mri.recon_cg_sense(
        kvd, est, vd, iters=CG_ITERS, lam=1e-3), RECON, plan, ["fft_fused", COLUMNS],
        composed, 3, 3)
    line["iters"] = CG_ITERS
    line["ms_per_iter"] = line["ms"] / CG_ITERS
    zf_est = mri.recon_zero_filled(kvd, est, vd)
    want = torch_cg_sense(torch, kvd, est, vd, CG_ITERS, lam=1e-3)
    line["float64_cg_nrmse_over_zero_filled"] = ratios(want, zf_est)
    gate(line, x, zf_est, 1.0, "zero_filled")
    check(line, rel_err(x, want), TOL_CG_F64, "rel_err_vs_float64_cg")
    emit(line)
    del ks, zf, kvd, est, x, zf_est, want

    # Two shots, the second moved by (3, -2) px, on the uniform mask: one study.
    shots = torch.from_numpy(mri.shot_masks(uniform, len(MOCO_SHIFTS))).to(dev)
    shifts = torch.tensor(MOCO_SHIFTS, dtype=torch.float32, device=dev)
    one, moco_shape = img[0], (len(MOCO_SHIFTS), c, h, w)
    km, line = call("moco_forward", lambda: mri.moco_forward(one, smaps, shots, shifts),
                    moco_shape, plan, ["fft_fused", COLUMNS], composed)
    moved = fourier_shift(torch, one.to(torch.complex64), shifts)
    check(line, rel_err(km, (centered(torch, smaps * moved[:, None]) * shots[:, None]).sum(0)),
          TOL_REQUEST)
    emit(line)
    recon, line = call("recon_cg_moco", lambda: mri.recon_cg_moco(
        km, smaps, shots, shifts, iters=MOCO_ITERS), moco_shape, plan, ["fft_fused", COLUMNS],
        composed, 3, 3)
    line["iters"] = MOCO_ITERS
    line["ms_per_iter"] = line["ms"] / MOCO_ITERS
    blind = mri.recon_cg_sense(km, smaps, uniform, iters=MOCO_ITERS)
    gate(line, recon[None], blind[None], 0.5, "motion_blind")
    emit(line)
    real_rows = ["fft_fused", "rfft_fused", "irfft_fused", COLUMNS]
    est, line = call("estimate_shot_shifts", lambda: mri.estimate_shot_shifts(km, smaps, shots),
                     moco_shape, {**plan, "rfft2d": resolve_call(
                         "rfft2d", (len(MOCO_SHIFTS), h, w), dev, dtype="float32").variant},
                     real_rows, list(FRAME_KERNELS) + ["fft_two_pass", "fft_cluster"])
    line["shifts"] = est.tolist()
    check(line, float(est[0].abs().max()), 1e-6, "ref_shot_err_px")
    check(line, float((est - shifts).abs().max()), 0.5, "max_shift_err_px")
    with_est = mri.nrmse(mri.recon_cg_moco(km, smaps, shots, est, iters=MOCO_ITERS), one)
    with_truth = mri.nrmse(recon, one)
    line["nrmse_with_estimate"], line["nrmse_with_truth"] = with_est, with_truth
    check(line, with_est - 1.25 * with_truth, 1e-3, "closing_the_loop")
    emit(line)
    torch.cuda.empty_cache()


def _obs_cost(torch, xfft, resolve_call):
    """What the telemetry costs a planned call, measured as the reference's
    ``benchmarks/obs_bench.py`` measures it: host wall time a call of a
    cached ``xfft.fft2``, each call waited for, on one (256, 256) frame (the
    reference's size) and on the k-space frames, and of a cached
    ``resolve_call`` alone. Three states, in reps that rotate their order:
    ``lit`` (the flight recorder and calibration ledger installed at
    ``repro_torch.obs`` import, and a capture scope), ``dark`` (the
    reference's baseline, as ``benchmarks/obs_bench.py`` makes it:
    ``xfft.config(flight_recorder=False)``, no scope) and ``bare`` (both
    sinks removed; the planner still builds its event's fields). The
    medians are set against the reference's 3% gate and recorded, not held."""
    from repro_torch import obs
    from repro_torch.obs import telemetry

    iters, reps = 200, 21
    dev = torch.device("cuda")
    frame = torch.randn(256, 256, device=dev, dtype=torch.complex64)
    frames = torch.randn(*MRI, device=dev, dtype=torch.complex64)

    def fft2_us(x):
        t0 = time.perf_counter()
        for _ in range(iters):
            xfft.fft2(x)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e6

    def resolve_us():
        t0 = time.perf_counter()
        for _ in range(10 * iters):
            resolve_call("fft2d", MRI, dev)
        return (time.perf_counter() - t0) / (10 * iters) * 1e6

    def run(state, fn):
        if state == "lit":
            with obs.capture():
                return fn()
        if state == "dark":
            with xfft.config(flight_recorder=False):
                return fn()
        saved = telemetry.flight_recorder(), telemetry.calibration_ledger()
        telemetry.set_flight_recorder(None)
        telemetry.set_calibration_ledger(None)
        try:
            return fn()
        finally:
            telemetry.set_flight_recorder(saved[0])
            telemetry.set_calibration_ledger(saved[1])

    states = ("lit", "dark", "bare")
    outer = obs.push_observe(False)  # out of the main path's capture: bare is bare
    cases = {"fft2 (256, 256)": lambda: fft2_us(frame),
             f"fft2 {tuple(MRI)}": lambda: fft2_us(frames),
             "resolve_call": resolve_us}
    line = {"phase": "mri", "call": "obs cost", "gate_pct": OBS_GATE_PCT, "iters": iters,
            "reps": reps}
    for name, fn in cases.items():
        fn()
        samples = {st: [] for st in states}
        for rep in range(reps):
            for st in states[rep % 3:] + states[:rep % 3]:
                samples[st].append(run(st, fn))
        us = {st: statistics.median(v) for st, v in samples.items()}
        line[name] = {f"{st}_us": v for st, v in us.items()}
        for base in ("dark", "bare"):
            line[name][f"overhead_pct_vs_{base}"] = (us["lit"] - us[base]) / us[base] * 100.0
        line[name]["within_gate"] = line[name]["overhead_pct_vs_bare"] <= OBS_GATE_PCT
        line[name]["within_gate_vs_dark"] = line[name]["overhead_pct_vs_dark"] <= OBS_GATE_PCT
    obs.pop_observe(outer)
    emit(line)
    del frame, frames


def _mri_double(torch, k, xfft, resolve_call, tap):
    """The double sub-phase: the eight transforms at complex128 against
    ``torch.fft`` in float64, and SENSE adjointness at 16 coils x 256^2,
    under ``xfft.config(precision="double")``. Every key plans
    ``reference_x64`` (the port's Stockham schedules at complex128), and
    no single-precision kernel launches."""
    from repro_torch import mri

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(64)
    c, h, w = RECON[1:]
    rows_shape, frames = X64_ROWS, (c, h, w)

    def rand(*shape, complex_=True):
        x = torch.randn(*shape, generator=gen, device=dev, dtype=torch.float64)
        return torch.complex(x, torch.randn_like(x)) if complex_ else x

    before, plain = dict(k.LAUNCHES), tap.plain_calls
    line = {"phase": "mri", "call": "double", "transforms": {}, "plan": {}}
    cases = (("fft", "fft1d", rows_shape, "fwd", rand(*rows_shape)),
             ("ifft", "fft1d", rows_shape, "inv", rand(*rows_shape)),
             ("rfft", "rfft1d", rows_shape, "fwd", rand(*rows_shape, complex_=False)),
             ("irfft", "rfft1d", rows_shape, "inv", rand(rows_shape[0], rows_shape[1] // 2 + 1)),
             ("fft2", "fft2d", frames, "fwd", rand(*frames)),
             ("ifft2", "fft2d", frames, "inv", rand(*frames)),
             ("rfft2", "rfft2d", frames, "fwd", rand(*frames, complex_=False)),
             ("irfft2", "rfft2d", frames, "inv", rand(c, h, w // 2 + 1)))
    with xfft.config(precision="double"):
        for name, kind, shape, direction, x in cases:
            dtype = "float32" if kind.startswith("rfft") else "complex64"
            plan = resolve_call(kind, shape, dev, dtype=dtype, direction=direction).variant
            got = getattr(xfft, name)(x)
            want = getattr(torch.fft, name)(x)
            out = {"plan": plan, "shape": list(shape), "dtype": str(got.dtype),
                   "rel_err": rel_err(got, want),
                   "ms": time_ms(lambda: getattr(xfft, name)(x), 3, 3),
                   "library_ms": time_ms(lambda: getattr(torch.fft, name)(x), 3, 3)}
            line["transforms"][name] = out
            if plan != "reference_x64" or got.dtype not in (torch.complex128, torch.float64):
                raise AssertionError(f"double {name}: planned {plan}, gave {got.dtype}")
            if not out["rel_err"] <= TOL_X64:
                raise AssertionError(f"double {name}: rel_err {out['rel_err']} > {TOL_X64}")
        smaps = torch.from_numpy(mri.birdcage_maps(c, h)).to(dev).to(torch.complex128)
        mask = torch.from_numpy(mri.uniform_mask((h, w), ACCEL, calib=CALIB)).to(dev)
        u, v = rand(h, w), rand(c, h, w)
        au = mri.sense_forward(u, smaps, mask)
        ahv = mri.sense_adjoint(v, smaps, mask)
        lhs, rhs = torch.vdot(au.flatten(), v.flatten()), torch.vdot(u.flatten(), ahv.flatten())
        line["plan"] = {"fft2d": resolve_call("fft2d", frames, dev).variant,
                        "fft2d inv": resolve_call("fft2d", frames, dev, direction="inv").variant}
        line["sense_forward_ms"] = time_ms(lambda: mri.sense_forward(u, smaps, mask), 3, 3)
        line["sense_adjoint_ms"] = time_ms(lambda: mri.sense_adjoint(v, smaps, mask), 3, 3)
    line["shape"] = list(frames)
    line["dtype"] = [str(au.dtype), str(ahv.dtype)]
    check(line, float((lhs - rhs).abs() / lhs.abs()), TOL_ADJOINT_X64, "adjointness_err")
    if set(line["plan"].values()) != {"reference_x64"} or au.dtype != torch.complex128:
        raise AssertionError(f"double SENSE: planned {line['plan']}, gave {au.dtype}")
    line["launches"] = {n: k.LAUNCHES[n] - before[n] for n in k.LAUNCHES
                        if k.LAUNCHES[n] != before[n]}
    line["plain_schedule_calls"] = tap.plain_calls - plain
    if line["launches"]:
        raise AssertionError(f"double: single-precision kernels launched: {line['launches']}")
    if line["plain_schedule_calls"] < 1:
        raise AssertionError("double: the plain schedules never ran")
    emit(line)
    torch.cuda.empty_cache()


def stream_engines(torch, k):
    """Patch the wrappers' launch to record each launch's CUDA stream;
    returns (records, restore): records is a list of (kernel, stream)."""
    seen, launch = [], k._launch

    def spy(entry, name, x, *args):
        seen.append((name, torch.cuda.current_stream(x.device).cuda_stream))
        return launch(entry, name, x, *args)

    k._launch = spy

    def restore():
        k._launch = launch

    return seen, restore


def one_stream(ops, z, unroll: int, radix: int):
    """The stream's steps in the same order, all on the caller's stream:
    what the two engines' concurrency is set against."""
    h, w = z.shape[-2], z.shape[-1]
    out = z.new_empty(z.shape)
    steps = -(-z.shape[0] // unroll)

    def view(a, s):
        return a[s * unroll:(s + 1) * unroll].reshape(-1, h, w)

    for s in range(steps + 1):
        if s:
            ops.stream_columns(view(out, s - 1), radix=radix)
        if s < steps:
            ops.stream_rows(view(z, s), view(out, s), radix=radix)
    return out


def captured(torch, fn):
    """``fn`` captured in a CUDA graph (warmed up on a side stream first, as
    PyTorch asks); returns (graph, its output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def stream_phase(torch, k, card: str):
    """The paper's ping-pong processor: ``repro_torch.core.fft2d.fft2_stream``
    as its users call it (variant and unroll planned), on
    examples/serve_fft2d.py's requests, CT slices, holograms and coil time
    series, then the double stream. Returns the launches of the checked
    calls (the main path's), for the ``kernels`` line."""
    from repro_torch.core.fft2d import fft2_stream
    from repro_torch.kernels import ops
    from repro_torch.plan.api import resolve

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    total = {kn: 0 for kn in STREAM_KERNELS}

    def planned_call(name, x):
        """One call as the user makes it; its launches and their streams
        checked: ceil(T/u) of each engine, rows on one stream, columns on
        another, neither the caller's."""
        plan = resolve("fft2d_stream", tuple(x.shape), dev)
        if plan.variant not in ("fused", "fused_r4"):
            raise AssertionError(f"stream {name}: planned {plan.variant}, not a kernel")
        seen, restore = stream_engines(torch, k)
        before = dict(k.LAUNCHES)
        try:
            got = fft2_stream(x)
            torch.cuda.synchronize()
        finally:
            restore()
        launches = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES
                    if k.LAUNCHES[kn] != before[kn]}
        steps = -(-x.shape[0] // plan.unroll)
        if launches != {kn: steps for kn in STREAM_KERNELS}:
            raise AssertionError(f"stream {name}: launches {launches}, want {steps} of each "
                                 f"of {STREAM_KERNELS}")
        streams = {kn: {s for n, s in seen if n == kn} for kn in STREAM_KERNELS}
        caller = torch.cuda.current_stream(dev).cuda_stream
        rows, cols = (streams[kn] for kn in STREAM_KERNELS)
        if len(rows) != 1 or len(cols) != 1 or rows == cols or caller in rows | cols:
            raise AssertionError(f"stream {name}: engines not on two side streams: {streams}")
        for kn in STREAM_KERNELS:
            total[kn] += launches[kn]
        return got, plan, launches

    def line_for(name, x, got, plan, launches):
        v, u = plan.variant, plan.unroll
        radix = 4 if v == "fused_r4" else 2
        frames = x.shape[0]
        lib = torch.fft.fft2(x)
        plain = fft2_stream(x, variant="radix4" if radix == 4 else "stockham", unroll=u)
        z = x.to(torch.complex64)
        n = z.numel()
        line = {"phase": "stream", "call": name, "shape": list(x.shape),
                "dtype": str(x.dtype).replace("torch.", ""), "card": card, "variant": v,
                "unroll": u, "launches_per_call": launches,
                "rel_err_vs_library": rel_err(got, lib), "max_abs_err_vs_library":
                max_abs(got, lib), "rel_err_vs_plain_stream": rel_err(got, plain),
                "by_unroll": {}}
        for uu in STREAM_UNROLLS:
            eager = lambda: fft2_stream(x, variant=v, unroll=uu)  # noqa: E731
            ref = eager()
            graph, replayed = captured(torch, eager)
            graph.replay()
            torch.cuda.synchronize()
            single = lambda: one_stream(ops, z, uu, radix)  # noqa: E731
            graph1, _ = captured(torch, single)
            row = {"ms": time_ms(eager), "one_stream_ms": time_ms(single),
                   "graph_ms": time_ms(graph.replay),
                   "one_stream_graph_ms": time_ms(graph1.replay),
                   "host_ms": enqueue_ms(torch, eager),
                   "replay_equal": bool(torch.equal(replayed, ref))}
            row["frames_per_s"] = frames / row["ms"] * 1e3
            row["graph_frames_per_s"] = frames / row["graph_ms"] * 1e3
            line["by_unroll"][uu] = row
            if not row["replay_equal"]:
                raise AssertionError(f"stream {name} unroll {uu}: graph replay differs")
            del graph, graph1, replayed, ref
        line["planned_ms"] = time_ms(lambda: fft2_stream(x))
        line["frames_per_s"] = frames / line["planned_ms"] * 1e3
        line["batched_route_ms"] = time_ms(lambda: ops.fft2_kernel(z, radix=radix))
        line["library_ms"] = time_ms(lambda: torch.fft.fft2(x))
        line["two_trip_floor_ms"] = 32 * n / hbm_bandwidth(card) * 1e3
        for what in ("rel_err_vs_library", "rel_err_vs_plain_stream"):
            if not line[what] <= TOL_KERNEL:
                raise AssertionError(f"stream {name}: {what} {line[what]} > {TOL_KERNEL}")
        emit(line)
        del lib, plain, z
        torch.cuda.empty_cache()

    # examples/serve_fft2d.py: each request a stream of real camera frames.
    requests, batch, h, w = STREAM_SERVE
    worst, peaks_agree = 0.0, True
    for step in range(0, requests * batch, batch):
        x = torch.from_numpy(frame_source(step, batch, h, w)).to(dev)
        got, plan, launches = planned_call("serve", x)
        ref = torch.fft.fft2(x)
        worst = max(worst, rel_err(got, ref))
        peaks_agree &= bool(torch.equal(peaks(got), peaks(ref)))
    if not (worst <= TOL_KERNEL and peaks_agree):
        raise AssertionError(f"stream serve: rel_err {worst}, peaks agree {peaks_agree}")
    line_for(f"serve_fft2d ({requests} requests)", x, got, plan, launches)
    for shape in STREAM_SHAPES:
        x = torch.complex(torch.randn(*shape, generator=gen, device=dev),
                          torch.randn(*shape, generator=gen, device=dev))
        got, plan, launches = planned_call(str(shape), x)
        line_for(str(tuple(shape)), x, got, plan, launches)
        del x, got
    # The double stream: reference_x64's pipeline at complex128, no kernel.
    from repro_torch import xfft

    x = torch.complex(torch.randn(*STREAM_X64, generator=gen, device=dev, dtype=torch.float64),
                      torch.randn(*STREAM_X64, generator=gen, device=dev, dtype=torch.float64))
    before = dict(k.LAUNCHES)
    with xfft.config(precision="double"):
        plan = resolve("fft2d_stream", STREAM_X64, dev)
        got = fft2_stream(x)
        ms = time_ms(lambda: fft2_stream(x), 3, 3)
    launched = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES
                if k.LAUNCHES[kn] != before[kn]}
    line = {"phase": "stream", "call": "double", "shape": list(STREAM_X64), "card": card,
            "variant": plan.variant, "dtype": str(got.dtype).replace("torch.", ""),
            "rel_err_vs_library": rel_err(got, torch.fft.fft2(x)), "ms": ms,
            "library_ms": time_ms(lambda: torch.fft.fft2(x), 3, 3), "launches": launched}
    emit(line)
    if plan.variant != "reference_x64" or got.dtype != torch.complex128 or launched:
        raise AssertionError(f"stream double: {line}")
    if not line["rel_err_vs_library"] <= TOL_X64:
        raise AssertionError(f"stream double: rel_err {line['rel_err_vs_library']}")
    del x, got
    torch.cuda.empty_cache()
    return total


class LaneTap:
    """Wraps a service loop's executor: per lane label, its batches, the
    requests they held, the wall ms of each batch (the executor waits for
    the card) and, while ``counting``, the kernels its batches launched."""

    def __init__(self, k, svc):
        self.k, self.lanes, self.counting = k, {}, True
        inner = svc.loop.execute

        def execute(lane, members):
            before, t0 = dict(k.LAUNCHES), time.perf_counter()
            try:
                inner(lane, members)
            finally:
                row = self.lanes.setdefault(lane.label(), {"batches": 0, "requests": 0,
                                                           "ms": [], "kernels": {}})
                row["batches"] += 1
                row["requests"] += len(members)
                row["ms"].append((time.perf_counter() - t0) * 1e3)
                if self.counting:
                    for n in k.LAUNCHES:
                        if k.LAUNCHES[n] != before[n]:
                            row["kernels"][n] = row["kernels"].get(n, 0) + k.LAUNCHES[n] - before[n]

        svc.loop.execute = execute

    def clear(self):
        self.lanes = {}

    def launches(self):
        total = {}
        for row in self.lanes.values():
            for n, c in row["kernels"].items():
                total[n] = total.get(n, 0) + c
        return total

    def summary(self):
        return {label: {"batches": r["batches"], "requests": r["requests"],
                        "ms_median": statistics.median(r["ms"]), "kernels": r["kernels"]}
                for label, r in self.lanes.items()}


def raw_latencies(loop):
    """Tee the loop's lane histograms: returns the list every recorded
    admission-to-completion sample (µs) is appended to, as the histogram
    sees it."""
    raw, lane_histogram = [], loop._lane_histogram

    class Tee:
        def __init__(self, h):
            self.h = h

        def record(self, us):
            raw.append(us)
            self.h.record(us)

        def __getattr__(self, name):
            return getattr(self.h, name)

    loop._lane_histogram = lambda lane: Tee(lane_histogram(lane))
    return raw


def latency_line(obs, prefix: str, raw):
    """p50/p99 of the lanes' merged ``LatencyHistogram`` beside the raw
    samples' nearest-rank p99, and how many buckets apart the two p99 lie."""
    merged = obs.LatencyHistogram()
    for h in obs.histograms(prefix=prefix).values():
        merged.merge(h)
    ranked = sorted(raw)
    raw_p99 = ranked[max(1, math.ceil(0.99 * len(ranked))) - 1]
    p99 = merged.percentile(99)
    return {"hist_n": merged.count, "hist_p50_us": merged.percentile(50), "hist_p99_us": p99,
            "raw_p50_us": ranked[max(1, math.ceil(0.5 * len(ranked))) - 1],
            "raw_p99_us": raw_p99,
            "p99_bucket_gap": abs(merged.bucket_index(p99) - merged.bucket_index(raw_p99))}


def card_ms(torch, fn, reps: int = 20) -> float:
    """Card time of one call of ``fn``: queued behind a sleep kernel, so the
    host's enqueue is hidden and the events bracket the card's work alone."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop))
    return statistics.median(samples)


def mixed_frames(torch, dev, count: int, h: int, w: int, seed: int):
    """``count`` frames on the card, real float32 and complex64 in turns."""
    g = torch.Generator(device=dev).manual_seed(seed)
    frames = []
    for i in range(count):
        re = torch.randn(h, w, generator=g, device=dev)
        frames.append(re if i % 2 == 0 else
                      torch.complex(re, torch.randn(h, w, generator=g, device=dev)))
    return frames


def spectrum_of(torch, frame):
    return torch.fft.fft2(frame) if frame.is_complex() else torch.fft.rfft2(frame)


def worst_spectrum_err(torch, reqs):
    worst = max(rel_err(r.spectrum, spectrum_of(torch, r.frame)) for r in reqs)
    if not (worst <= TOL_REQUEST and all(r.done and r.spectrum.is_cuda for r in reqs)):
        raise AssertionError(f"serve: spectra off by {worst} (or not done on the card)")
    return worst


def serve_phase(torch, k, card: str):
    """``repro_torch.serve`` as its users call it: SpectrumService
    call-scoped and streaming, the composed-route lanes, one mixed
    ImagingService queue, a started loop fed by four threads, and a
    warm-started MEASURE service. Returns the launches of the services'
    checked calls (the main path's), for the ``kernels`` line."""
    from repro_torch import obs

    total = {}
    for part in (_serve_spectrum, _serve_imaging, _serve_loop, _serve_wisdom):
        for n, c in part(torch, k, card).items():
            total[n] = total.get(n, 0) + c
    missing = [n for n in SERVE_KERNELS if not total.get(n)]
    if missing:
        raise AssertionError(f"serve: {missing} never launched ({total})")
    obs.reset_histograms()
    torch.cuda.empty_cache()
    return total


def _serve_spectrum(torch, k, card: str):
    from repro_torch import obs
    from repro_torch.plan import execute
    from repro_torch.serve import BatchPolicy, SpectrumRequest, SpectrumService
    from repro_torch.serve.engine import _stack

    dev = torch.device("cuda")
    n, h, w = SERVE_MIX
    frames = mixed_frames(torch, dev, n, h, w, seed=28)
    launched, runs = {}, {}
    for style in ("call-scoped", "streaming"):
        svc = SpectrumService(batch=BatchPolicy(max_batch=SERVE_BATCH))
        tap = LaneTap(k, svc)
        raw = raw_latencies(svc.loop)
        svc.serve([SpectrumRequest(frame=f) for f in frames[:2]])  # plan both lanes
        obs.reset_histograms()
        tap.clear()
        raw.clear()
        reqs = [SpectrumRequest(frame=f) for f in frames]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if style == "call-scoped":
            for i in range(0, n, SERVE_BATCH):
                svc.serve(reqs[i:i + SERVE_BATCH])
        else:
            for r in reqs:
                svc.loop.submit(r)
            svc.loop.drain()
        wall = time.perf_counter() - t0
        lanes = tap.summary()
        line = {"phase": "serve", "call": f"spectrum {style}", "card": card,
                "frames": [n, h, w], "max_batch": SERVE_BATCH,
                "dispatches": sum(r["batches"] for r in lanes.values()),
                "requests_per_s": n / wall, "wall_ms": wall * 1e3,
                **latency_line(obs, "serve.lane.spectrum.", raw),
                "rel_err": worst_spectrum_err(torch, reqs), "lanes": lanes}
        emit(line)
        if line["p99_bucket_gap"] > 1:
            raise AssertionError(f"serve {style}: histogram p99 {line['hist_p99_us']} more than "
                                 f"one bucket from the raw p99 {line['raw_p99_us']}")
        runs[style] = line
        for name, c in tap.launches().items():
            launched[name] = launched.get(name, 0) + c
    if runs["streaming"]["dispatches"] > runs["call-scoped"]["dispatches"]:
        raise AssertionError(f"serve: the loop dispatched {runs['streaming']['dispatches']} "
                             f"batches, the call-scoped run {runs['call-scoped']['dispatches']}")

    # Where a 128² lane's host time goes: stack, plan (memo hit), the
    # engine's op enqueued, the wait; beside the op's card time.
    svc = SpectrumService()
    for real in (True, False):
        members = [SpectrumRequest(frame=f) for f in frames[(0 if real else 1)::2][:SERVE_BATCH]]
        lane = svc._classify(members[0])
        shape, _, _ = lane.signature
        kind, dtype = ("rfft2d", "float32") if real else ("fft2d", "complex64")
        xdtype = torch.float32 if real else torch.complex64
        svc._execute_lane(lane, members)
        split = {"stack": [], "plan": [], "op_enqueue": [], "wait": [], "executor": []}
        for _ in range(50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = _stack([r.frame for r in members], dev, xdtype)
            t1 = time.perf_counter()
            plan = svc._plan_for(kind, shape, dtype, dev)
            t2 = time.perf_counter()
            execute(plan, batch)
            t3 = time.perf_counter()
            torch.cuda.current_stream().synchronize()
            t4 = time.perf_counter()
            svc._execute_lane(lane, members)
            t5 = time.perf_counter()
            for key, a, b in (("stack", t0, t1), ("plan", t1, t2), ("op_enqueue", t2, t3),
                              ("wait", t3, t4), ("executor", t4, t5)):
                split[key].append((b - a) * 1e6)
        kernel = (lambda: k.rfft2_fused(batch, radix=4)) if real else (
            lambda: k.fft2_fused(batch, radix=4))
        emit({"phase": "serve", "call": "host split", "lane": lane.label(), "card": card,
              "batch": len(members), "variant": plan.variant,
              **{f"{key}_us": statistics.median(v) for key, v in split.items()},
              "op_card_us": card_ms(torch, lambda: execute(plan, batch)) * 1e3,
              "kernel_card_us": card_ms(torch, kernel) * 1e3})

    # Frames over one block: a lane of CT slices and one of holograms, each
    # on the composed route (a row kernel, then fft2_columns).
    for name, shape, real, want in (
            ("CT", SERVE_CT, False, {"fft_fused", COLUMNS}),
            ("holograms", SERVE_HOLO, True, {"rfft_fused", COLUMNS})):
        b, h, w = shape
        g = torch.Generator(device=dev).manual_seed(b)
        x = torch.randn(b, h, w, generator=g, device=dev)
        if not real:
            x = torch.complex(x, torch.randn(b, h, w, generator=g, device=dev))
        svc = SpectrumService()
        # The lane's first batch, step by step: a new shape's first call.
        kind, dtype = ("rfft2d", "float32") if real else ("fft2d", "complex64")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = _stack(list(x), dev, x.dtype)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plan = svc._plan_for(kind, (h, w), dtype, dev)
        t2 = time.perf_counter()
        execute(plan, batch)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        first = {"stack_ms": (t1 - t0) * 1e3, "plan_ms": (t2 - t1) * 1e3,
                 "op_enqueue_ms": (t3 - t2) * 1e3, "wait_ms": (t4 - t3) * 1e3}
        del batch
        tap = LaneTap(k, svc)
        reqs = [SpectrumRequest(frame=f) for f in x]
        svc.serve(reqs)
        lanes = tap.summary()
        kernels = tap.launches()
        if set(kernels) != want:
            raise AssertionError(f"serve {name}: launched {kernels}, want {sorted(want)}")
        for n_, c in kernels.items():
            launched[n_] = launched.get(n_, 0) + c
        err = worst_spectrum_err(torch, reqs)
        tap.counting = False
        emit({"phase": "serve", "call": f"spectrum {name}", "card": card, "shape": list(shape),
              "dtype": str(x.dtype).replace("torch.", ""), "rel_err": err,
              "first_batch": first, "lanes": lanes,
              "serve_ms": time_ms(lambda: svc.serve(reqs), 3, 3),
              "library_ms": time_ms(lambda: spectrum_of(torch, x), 3, 3)})
        del x, reqs
    torch.cuda.empty_cache()
    return launched


def _serve_imaging(torch, k, card: str):
    import numpy as np

    from repro_torch import mri, obs
    from repro_torch.imaging import apply_shift, oaconvolve2, register_phase_correlation
    from repro_torch.serve import (ConvolutionRequest, ImagingService, ReconRequest,
                                   RegistrationRequest, SpectrumRequest)

    dev = torch.device("cuda")
    pairs, side, up = SERVE_REG
    refs = torch.from_numpy(band_limited_frames(side, pairs, seed=28)).to(dev)
    whole = torch.tensor([[3.0 + i, -2.0 - 2 * i] for i in range(pairs)], device=dev)
    sub = torch.tensor([[1.5 + 0.3 * i, -0.7 + 0.2 * i] for i in range(pairs)], device=dev)
    movs1, movs10 = apply_shift(refs, whole), apply_shift(refs, sub)
    n_conv, hside, ksize = SERVE_CONV
    g = torch.Generator(device=dev).manual_seed(31)
    images = torch.randn(n_conv, hside, hside, generator=g, device=dev)
    kernels = torch.randn(n_conv, ksize, ksize, generator=g, device=dev)
    n_rec, coils, rh, rw = SERVE_RECON
    phantom = mri.shepp_logan(rh)
    studies = torch.from_numpy(np.stack([phantom, phantom[::-1], phantom[:, ::-1],
                                         np.roll(phantom, rh // 16, 0)])[:n_rec].copy()).to(dev)
    smaps = torch.from_numpy(mri.birdcage_maps(coils, rh)).to(dev)
    mask = torch.from_numpy(mri.uniform_mask((rh, rw), ACCEL, calib=CALIB)).to(dev)  # on the card
    kspace = mri.sense_forward(studies, smaps, mask)
    families = {
        "registration": [RegistrationRequest(ref=refs[i], mov=movs1[i]) for i in range(pairs)],
        "upsampled": [RegistrationRequest(ref=refs[i], mov=movs10[i], upsample=up)
                      for i in range(pairs)],
        "convolution": [ConvolutionRequest(image=images[i], kernel=kernels[i])
                        for i in range(n_conv)],
        "recon": [ReconRequest(kspace=kspace[i], smaps=smaps, mask=mask, iters=CG_ITERS)
                  for i in range(n_rec)],
        "spectrum": [SpectrumRequest(frame=f)
                     for f in mixed_frames(torch, dev, 16, 128, 128, seed=16)],
    }
    reqs = [r for fam in families.values() for r in fam]
    reqs = [reqs[i] for i in np.random.default_rng(28).permutation(len(reqs))]
    svc = ImagingService()
    tap = LaneTap(k, svc)
    with obs.capture() as trace:
        svc.serve(reqs)
    lanes = tap.summary()
    launched = tap.launches()
    (queue,) = trace.select("serve.queue")
    coarse = torch.stack([r.shift for r in families["registration"]])
    fine = torch.stack([r.shift for r in families["upsampled"]])
    recons = torch.stack([r.image for r in families["recon"]])
    conv_plan = next(p for p in svc.plans.values() if p.key.kind == "oaconv2d")
    errs = {
        "registration": rel_err(coarse, register_phase_correlation(refs, movs1)),
        "registration_upsampled": rel_err(
            fine, register_phase_correlation(refs, movs10, upsample_factor=up)),
        "convolution": rel_err(torch.stack([r.out for r in families["convolution"]]),
                               oaconvolve2(images, kernels, mode="same", tile=conv_plan.tile)),
        "recon": rel_err(recons, mri.recon_cg_sense(
            kspace, smaps[None].expand(n_rec, -1, -1, -1),
            mask=mask[None, None].expand(n_rec, 1, -1, -1), iters=CG_ITERS)),
        "spectrum": worst_spectrum_err(torch, families["spectrum"]),
    }
    zero_filled = mri.recon_zero_filled(kspace, smaps, mask)
    line = {"phase": "serve", "call": "imaging", "card": card, "requests": len(reqs),
            "serve_queue": {f: queue[f] for f in ("spectra", "registrations", "convolutions",
                                                   "recons")},
            "rel_err": errs, "lanes": lanes, "conv_tile": list(conv_plan.tile),
            "whole_shift_err_px": float((coarse + whole).abs().max()),
            "subpixel_shift_err_px": float((fine + sub).abs().max()),
            "recon_nrmse_over_zero_filled": [
                mri.nrmse(recons[i], studies[i]) / mri.nrmse(zero_filled[i], studies[i])
                for i in range(n_rec)]}
    tap.counting = False
    line["serve_ms"] = time_ms(lambda: svc.serve(reqs), 1, 3)
    emit(line)
    bad = {n: e for n, e in errs.items() if not e <= TOL_REQUEST}
    if bad or line["whole_shift_err_px"] != 0.0 or len(lanes) != 6:
        raise AssertionError(f"serve imaging: {bad}, whole-pixel shifts off by "
                             f"{line['whole_shift_err_px']}, lanes {list(lanes)}")
    del kspace, images, refs, families, reqs
    torch.cuda.empty_cache()
    return launched


def _serve_loop(torch, k, card: str):
    import threading

    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchPolicy, SpectrumRequest, SpectrumService

    dev = torch.device("cuda")
    threads, each, max_batch, max_wait = SERVE_LOOP
    frames = mixed_frames(torch, dev, threads * each, 128, 128, seed=4)
    svc = SpectrumService(batch=BatchPolicy(max_batch=max_batch, max_wait_s=max_wait))
    svc.serve([SpectrumRequest(frame=f) for f in frames[:2]])  # plan both lanes
    tap = LaneTap(k, svc)
    tap.clear()
    raw = raw_latencies(svc.loop)
    obs.reset_histograms()
    recorder = obs.flight_recorder()
    if recorder is None:
        raise AssertionError("serve loop: the flight recorder is off")
    tickets, lock = [], threading.Lock()

    def submitter(part):
        for f in part:
            t = svc.loop.submit(SpectrumRequest(frame=f))
            with lock:
                tickets.append(t)

    t_start = time.perf_counter()
    svc.loop.start()
    loop_tid = svc.loop._thread.ident
    workers = [threading.Thread(target=submitter, args=(frames[i::threads],))
               for i in range(threads)]
    for th in workers:
        th.start()
    for th in workers:
        th.join()
    for t in tickets:
        t.result(timeout=60.0)
    wall = time.perf_counter() - t_start
    svc.loop.stop(timeout=5.0)
    if svc.loop.queue.depth() or not all(t.done for t in tickets) or len(tickets) != len(frames):
        raise AssertionError("serve loop: stop() left work behind")
    window = [e for e in recorder.events() if e.t >= t_start]
    if recorder.stats()["recorded_total"] - len(recorder.events()) and (
            not recorder.events() or recorder.events()[0].t >= t_start):
        raise AssertionError("serve loop: the flight recorder dropped part of the window")
    loop_events = [e for e in window if e.tid == loop_tid]
    lanes = tap.summary()
    line = {"phase": "serve", "call": "loop", "card": card, "submitters": threads,
            "frames_each": each, "max_batch": max_batch, "max_wait_s": max_wait,
            "dispatches": sum(r["batches"] for r in lanes.values()),
            "requests_per_s": len(frames) / wall, "wall_ms": wall * 1e3,
            **latency_line(obs, "serve.lane.spectrum.", raw),
            "rel_err": worst_spectrum_err(torch, [t.request for t in tickets]),
            "recorder_window_events": len(window), "loop_thread_events": len(loop_events),
            "lanes": lanes}
    emit(line)
    if not loop_events or not any(e.name == "serve.loop.tick" for e in loop_events):
        raise AssertionError("serve loop: no tick of the loop thread reached the recorder")
    trace = obs.Trace()
    for e in window:
        trace.append(e)
    no_degrade(trace, "serve loop (flight recorder)", ops)
    return tap.launches()


def _serve_wisdom(torch, k, card: str):
    import os
    import tempfile

    from repro_torch import obs, xfft
    from repro_torch.plan import PlanCache
    from repro_torch.serve import SpectrumRequest, SpectrumService, wisdom

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tuned = wisdom.pretune(SERVE_WISDOM, cache=PlanCache(), device=dev)
    pretune_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = wisdom.export(os.path.join(d, "cuda.json"), tuned)
        warm = PlanCache()
        report = wisdom.warm_start(path, cache=warm)
    frames = []
    for n in SERVE_WISDOM:
        frames += mixed_frames(torch, dev, 4, n, n, seed=n)
    svc = SpectrumService(plan_mode="measure", cache=warm)
    tap = LaneTap(k, svc)
    reqs = [SpectrumRequest(frame=f) for f in frames]
    with obs.capture() as trace:
        svc.serve(reqs)
    outcomes = [e["outcome"] for e in trace.select("plan.resolve")]
    data = xfft.report_data(cache=warm)
    hits = {e["key"]: e["hits"] for e in data["cache"]["entries"]}
    text = xfft.report(cache=warm)
    packaged = wisdom.artifact_path("cuda")
    shipped = None
    if packaged is not None:
        ship = PlanCache()
        rep = wisdom.warm_start(packaged, cache=ship)
        shipped = {"kept": rep.kept, "file_error": rep.file_error,
                   "this_card": sum(p.key.device_kind == torch.cuda.get_device_name(dev)
                                    for _, p in ship.entries())}
    line = {"phase": "serve", "call": "wisdom", "card": card, "sizes": list(SERVE_WISDOM),
            "pretune_s": pretune_s,
            "tuned": {kk: p.variant for kk, p in tuned.entries()},
            "warm_start": report.to_dict(), "plan_measure_spans": len(trace.select("plan.measure")),
            "resolve_outcomes": outcomes, "hits": hits, "report_lines": len(text.splitlines()),
            "rel_err": worst_spectrum_err(torch, reqs), "lanes": tap.summary(),
            "packaged_cuda_artifact": shipped}
    emit(line)
    if (report.kept != 2 * len(SERVE_WISDOM) or line["plan_measure_spans"]
            or set(outcomes) != {"hit"} or len(outcomes) != 2 * len(SERVE_WISDOM)
            or min(hits.values()) < 1 or len(hits) != 2 * len(SERVE_WISDOM)):
        raise AssertionError(f"serve wisdom: {line}")
    return tap.launches()


def serve_fault_phase(torch, k, card: str) -> None:
    """The serve layer's fault seam and shedding, outside the main path's
    capture: a ``serve.batch`` fault firing once is retried and the lane
    is right; a ``max_queue`` smaller than the call sheds it with
    ``Overloaded`` before any lane runs."""
    from repro_torch import obs, xfft
    from repro_torch.resilience import FaultPlan, FaultSpec, Overloaded, ServicePolicy
    from repro_torch.serve import BatchPolicy, SpectrumRequest, SpectrumService

    dev = torch.device("cuda")
    frames = mixed_frames(torch, dev, 2 * SERVE_BATCH, 128, 128, seed=5)
    svc = SpectrumService(policy=ServicePolicy(max_retries=1, backoff_s=0.0),
                          batch=BatchPolicy(max_batch=SERVE_BATCH))
    reqs = [SpectrumRequest(frame=f) for f in frames]
    with obs.capture() as trace, xfft.config(
            faults=FaultPlan(FaultSpec("serve.batch", mode="error", times=1))):
        svc.serve(reqs)
    line = {"phase": "serve", "call": "fault", "card": card,
            "retries": len(trace.select("resilience.retry")),
            "faults": len(trace.select("resilience.fault")),
            "batches": len(trace.select("serve.batch")),
            "rel_err": worst_spectrum_err(torch, reqs)}
    shed_svc = SpectrumService(policy=ServicePolicy(max_queue=SERVE_BATCH // 2))
    shed_reqs = [SpectrumRequest(frame=f) for f in frames[:SERVE_BATCH]]
    before = dict(k.LAUNCHES)
    with obs.capture() as shed_trace:
        try:
            shed_svc.serve(shed_reqs)
            shed = None
        except Overloaded as e:
            shed = {"depth": e.depth, "limit": e.limit}
    line["shed"] = shed
    line["shed_batches"] = len(shed_trace.select("serve.batch"))
    line["shed_events"] = len(shed_trace.select("serve.shed"))
    line["shed_launches"] = sum(k.LAUNCHES[n] - before[n] for n in k.LAUNCHES)
    emit(line)
    if (line["retries"] != 1 or line["faults"] != 1 or shed != {"depth": SERVE_BATCH,
                                                                  "limit": SERVE_BATCH // 2}
            or line["shed_batches"] or line["shed_launches"] or line["shed_events"] != 1
            or any(r.done for r in shed_reqs)):
        raise AssertionError(f"serve fault: {line}")


def pencil_trips(shape, chunks, overlapped: bool) -> float:
    """HBM round trips (complex64, read and write) of a world-1 pencil call
    on real frames: the cast (0.75 of a trip), the rows, NCCL's
    self-exchange copy and the columns (in place, or the turn route's turn,
    rows, turn); the overlapped call adds the gather's copy and its
    reorder, and with several slabs their pack."""
    from repro_torch.kernels import fft_radix2 as k

    trips = 0.75 + 1 + 1 + (1 if k.fft2_columns_serves(shape[-2]) else 3)
    if overlapped:
        trips += 2 + (chunks > 1)
    return trips


def composed_trips(shape) -> float:
    """The same for ``xfft.fft2``: the cast, the rows and the columns."""
    from repro_torch.kernels import fft_radix2 as k

    return 0.75 + 1 + (1 if k.fft2_columns_serves(shape[-2]) else 3)


def pencil_input(torch, dev, shape, seed: int):
    """Real frames from a seeded generator on the card: the same tensor in
    every process on the same card."""
    return torch.randn(*shape, generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev)


def pencil_phase(torch, k, card: str):
    """The multi-device pencil FFT on the card: one rank on NCCL at the
    users' sizes, then gloo groups of several ranks sharing the card.
    Returns the NCCL calls' launches (the main path's), for the
    ``kernels`` line."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch import xfft
    from repro_torch.compat import make_mesh
    from repro_torch.core import distributed as pencil
    from repro_torch.plan.api import resolve

    dev = torch.device("cuda")
    total = {kn: 0 for kn in PENCIL_KERNELS}
    bw = hbm_bandwidth(card)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh((1,), ("data",))
            for i, shape in enumerate(PENCIL_FRAMES):
                x = pencil_input(torch, dev, shape, seed=29 + i)
                plan = resolve("fft2d_pencil", shape, dev, n_devices=1)
                if plan.variant not in ("fused", "fused_r4"):
                    raise AssertionError(f"pencil {shape}: planned {plan.variant}, not a kernel")
                plain_variant = "radix4" if plan.variant == "fused_r4" else "stockham"
                lib = torch.fft.fft2(x)
                n = lib.numel()
                yardsticks = {"composed_ms": time_ms(lambda: xfft.fft2(x), 5, 5),
                              "library_ms": time_ms(lambda: torch.fft.fft2(x), 5, 5),
                              "composed_floor_ms": composed_trips(shape) * 16 * n / bw * 1e3}
                for name, chunks in (("fft2_pencil", None), ("fft2_pencil_overlapped", plan.chunks),
                                     ("fft2_pencil_overlapped", PENCIL_CHUNKS)):
                    fn = getattr(pencil, name)
                    kw = {} if chunks is None else {"chunks": chunks}
                    c = chunks or 1

                    def run(variant, fn=fn, kw=kw):
                        return fn(x, mesh, variant=variant, **kw).to_local()

                    before = dict(k.LAUNCHES)
                    pencil.reset_collectives()
                    got = run(plan.variant)
                    torch.cuda.synchronize()
                    launches = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES
                                if k.LAUNCHES[kn] != before[kn]}
                    collectives = dict(pencil.COLLECTIVES)
                    plain = run(plain_variant)
                    trips = pencil_trips(shape, c, chunks is not None)
                    line = {"phase": "pencil", "call": name, "shape": list(shape), "world": 1,
                            "backend": "nccl", "card": card, "variant": plan.variant,
                            "plan_chunks": plan.chunks, "chunks": c, "launches": launches,
                            "collectives": collectives,
                            "rel_err_vs_library": rel_err(got, lib),
                            "max_abs_err_vs_library": max_abs(got, lib),
                            "rel_err_vs_plain": rel_err(got, plain),
                            "ms": time_ms(lambda: run(plan.variant), 5, 5), **yardsticks,
                            "trips": trips, "hbm_floor_ms": trips * 16 * n / bw * 1e3}
                    line["over_composed"] = line["ms"] / line["composed_ms"]
                    line["over_floor"] = line["ms"] / line["hbm_floor_ms"]
                    emit(line)
                    del got, plain
                    columns = k.fft2_columns_serves(shape[-2])
                    want_launches = {"fft_fused": 1 + (0 if columns else c)}
                    if columns:
                        want_launches["fft2_columns"] = c
                    want_collectives = {"all_to_all_single": c,
                                        "all_gather_into_tensor": int(chunks is not None)}
                    if launches != want_launches or collectives != want_collectives:
                        raise AssertionError(f"pencil {name} {shape}: launches {launches}, "
                                             f"collectives {collectives}, want {want_launches}, "
                                             f"{want_collectives}")
                    for what in ("rel_err_vs_library", "rel_err_vs_plain"):
                        if not line[what] <= TOL_KERNEL:
                            raise AssertionError(f"pencil {name} {shape}: {what} {line[what]}")
                    for kn in PENCIL_KERNELS:
                        total[kn] += launches.get(kn, 0)
                del x, lib
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    for world in PENCIL_WORLDS:
        pencil_group(torch, card, world)
    return total


def pencil_group(torch, card: str, world: int) -> None:
    """``world`` gloo ranks sharing the card, each a process running
    :func:`pencil_rank`; a failing or late rank fails the phase. The
    library is built already (``main`` builds it first), so the ranks only
    load it."""
    import os
    import tempfile

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--pencil-rank", str(r),
                     str(world), tmp], stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PENCIL_DEADLINE_S
        for r, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                for q in procs:
                    q.kill()
                    q.wait()
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    raise AssertionError(f"pencil group of {world}: rank {r} exit {rc}: "
                                         f"{f.read()[-3000:]}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        blocks = [torch.load(os.path.join(tmp, f"fft2_pencil{r}.pt")) for r in range(world)]
        wholes = [torch.load(os.path.join(tmp, f"fft2_pencil_overlapped{r}.pt"))
                  for r in range(world)]
    x = pencil_input(torch, dev, PENCIL_GROUP, seed=290)
    lib = torch.fft.fft2(x).cpu()
    line = {"phase": "pencil", "call": "gloo group", "world": world, "backend": "gloo",
            "card": card, "shape": list(PENCIL_GROUP), "variant": ranks[0]["variant"],
            "rel_err_vs_library": rel_err(torch.cat(blocks, dim=-1), lib),
            "overlapped_rel_err_vs_library": max(rel_err(w, lib) for w in wholes),
            "ranks": ranks,
            "note": "gloo stages the exchange through host memory: not the NCCL number"}
    emit(line)
    c = PENCIL_GROUP_CHUNKS
    want = {"fft2_pencil": ({"fft_fused": 1, "fft2_columns": 1},
                            {"all_to_all_single": 1, "all_gather_into_tensor": 0}),
            "fft2_pencil_overlapped": ({"fft_fused": 1, "fft2_columns": c},
                                       {"all_to_all_single": c, "all_gather_into_tensor": 1})}
    for rank in ranks:
        for name, (launches, collectives) in want.items():
            if (rank[name]["launches"], rank[name]["collectives"]) != (launches, collectives):
                raise AssertionError(f"pencil group of {world}: rank {rank['rank']} {name}: "
                                     f"{rank[name]}, want {launches}, {collectives}")
    for what in ("rel_err_vs_library", "overlapped_rel_err_vs_library"):
        if not line[what] <= TOL_KERNEL:
            raise AssertionError(f"pencil group of {world}: {what} {line[what]}")


def pencil_rank(rank: int, world: int, tmp: str) -> int:
    """``--pencil-rank RANK WORLD DIR``: one rank of a gloo group on the
    card (a ``FileStore`` in DIR): ``fft2_pencil`` and
    ``fft2_pencil_overlapped`` on the group's frame, as planned; writes its
    blocks, launches, collectives and host ms a call to DIR."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.compat import make_mesh
        from repro_torch.core import distributed as pencil
        from repro_torch.kernels import fft_radix2 as k
        from repro_torch.plan.api import resolve

        dev = torch.device("cuda")
        mesh = make_mesh((world,), ("data",))
        x = pencil_input(torch, dev, PENCIL_GROUP, seed=290)
        plan = resolve("fft2d_pencil", PENCIL_GROUP, dev, n_devices=world)
        out = {"rank": rank, "variant": plan.variant, "plan_chunks": plan.chunks}
        for name, kw in (("fft2_pencil", {}),
                         ("fft2_pencil_overlapped", {"chunks": PENCIL_GROUP_CHUNKS})):
            fn = getattr(pencil, name)
            before = dict(k.LAUNCHES)
            pencil.reset_collectives()
            y = fn(x, mesh, variant=plan.variant, **kw).to_local()
            torch.cuda.synchronize()
            result = {"launches": {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES
                                   if k.LAUNCHES[kn] != before[kn]},
                      "collectives": dict(pencil.COLLECTIVES)}
            torch.save(y.cpu(), os.path.join(tmp, f"{name}{rank}.pt"))
            samples = []
            for _ in range(5):
                dist.barrier()
                t0 = time.perf_counter()
                fn(x, mesh, variant=plan.variant, **kw)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            result["host_ms_median"] = statistics.median(samples)
            out[name] = result
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


class LmTap:
    """A ``Model`` whose ``prefill_fn`` and ``decode_fn`` record, for each
    call, the launches of ``kernel`` it made and CUDA events around it
    (``self.model``; ``calls`` in order)."""

    def __init__(self, torch, model, kernel: str = "flash_attention_fwd"):
        import dataclasses

        from repro_torch.kernels._launch import LAUNCHES

        self.torch, self.launches, self.calls, self.kernel = torch, LAUNCHES, [], kernel
        self.model = dataclasses.replace(model, prefill_fn=self._wrap("prefill", model.prefill_fn),
                                         decode_fn=self._wrap("decode", model.decode_fn))

    def _wrap(self, kind, fn):
        def run(*args, **kw):
            before = self.launches[self.kernel]
            start = self.torch.cuda.Event(enable_timing=True)
            stop = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            self.calls.append((kind, self.launches[self.kernel] - before, start, stop))
            return out

        return run

    def take(self):
        """{kind: [(launches, ms), ...]} of the calls since the last take."""
        self.torch.cuda.synchronize()
        out = {"prefill": [], "decode": []}
        for kind, n, start, stop in self.calls:
            out[kind].append((n, start.elapsed_time(stop)))
        self.calls.clear()
        return out


@contextlib.contextmanager
def reference_attention(attn):
    """The model's prefill attention as the reference's function in plain
    tensor ops (``flash_attention_blocks``, in the compute dtype) on the
    card's tensors: a yardstick, which launches nothing."""
    route = attn.flash_attention
    attn.flash_attention = attn.flash_attention_blocks
    try:
        yield
    finally:
        attn.flash_attention = route


def lm_golden(torch, model, params, toks, max_len: int, extras=None):
    """Decode logits after a prefill of all but the last token, the prefill
    of all, and the prefill of all but the last's logits (``extras``, such
    as whisper's frames, go with both prefills)."""
    b, s = toks.shape[0], toks.shape[1] - 1
    dev = toks.device
    extras = extras or {}
    full, _ = model.prefill_fn(params, {"tokens": toks, **extras},
                               model.init_cache_fn(b, max_len, torch.float32, dev))
    pre, caches = model.prefill_fn(params, {"tokens": toks[:, :s], **extras},
                                   model.init_cache_fn(b, max_len, torch.float32, dev))
    dec, _ = model.decode_fn(params, toks[:, s:], s, caches)
    return dec, full, pre


def lm_queue(cfg, requests: int, prompt_len: int, max_new: int):
    """The launcher's queue (src/repro_torch/launch/serve.py): prompts from
    ``np.random.default_rng(0)``."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab, (prompt_len,)).astype(np.int32),
                    max_new=max_new) for _ in range(requests)]


def lm_phase(torch, card: str, rows) -> int:
    """repro_torch's LM serving at llama3.2-3b's full width; returns the
    ``flash_attention_fwd`` launches of the serving run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models import attention as attn
    from repro_torch.models.build import build
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.param import param_bytes, tree_leaves, tree_map
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    model = build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = phase_t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": "lm", "call": "init", "arch": cfg.name, "n_params": model.n_params,
          "param_bytes": param_bytes(model.skeleton), "seconds": time.perf_counter() - t0,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab, "compute_dtype": cfg.compute_dtype,
          "card": card})

    # Serve both queues with the counts set to 0 just before and read just
    # after: every lane batch's prefill launches the kernel once a layer,
    # a decode step never; no other kernel runs.
    tap = LmTap(torch, model)
    engines = [ServeEngine(tap.model, params, batch=batch, max_len=max_len, dtype=torch.float32)
               for _, _, _, batch, _, max_len in LM_QUEUES]
    queues = [lm_queue(cfg, n, plen, max_new) for _, n, plen, _, max_new, _ in LM_QUEUES]
    torch.cuda.synchronize()
    reset_launches()
    for eng, queue in zip(engines, queues):
        eng.serve_queue(queue)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    counted = tap.take()
    lane_batches = [-(-n // batch) for _, n, _, batch, _, _ in LM_QUEUES]
    per_prefill = [n for n, _ in counted["prefill"]]
    per_decode = [n for n, _ in counted["decode"]]
    others = {name: n for name, n in launches.items() if n and name != "flash_attention_fwd"}
    emit({"phase": "lm", "call": "launches", "flash_attention_fwd": launches["flash_attention_fwd"],
          "lane_batches": sum(lane_batches), "per_prefill": per_prefill,
          "decode_steps": len(per_decode), "decode_launches": sum(per_decode), "others": others})
    if (per_prefill != [cfg.n_layers] * sum(lane_batches) or any(per_decode) or others
            or launches["flash_attention_fwd"] != cfg.n_layers * sum(lane_batches)):
        raise AssertionError(f"lm: flash_attention_fwd launched {per_prefill} a prefill, "
                             f"{sum(per_decode)} on decode steps, others {others}")
    for queue, (label, _, _, _, max_new, _) in zip(queues, LM_QUEUES):
        if not all(r.done and len(r.out) == max_new and all(0 <= t < cfg.vocab for t in r.out)
                   for r in queue):
            raise AssertionError(f"lm {label}: a request was not served in full")

    # The kernel against its plain version at the lanes' shapes (B·H 96,
    # S 16 and 1024, D 128, causal, the config's blocks): seeded Gaussian
    # operands, k and v from 8 kv heads, at 2e-5; and the model's own
    # layer-0 operands on the lanes' prompts, held to float64.
    dt = getattr(torch, cfg.compute_dtype)
    p0 = tree_map(lambda t: t[0], params["dense_layers"])
    kernel_ms = {}
    for queue, nb, (label, _, s, b, _, _) in zip(queues, lane_batches, LM_QUEUES):
        toks = torch.from_numpy(np.stack([r.prompt for r in queue[:b]])).to(dev)
        h = rmsnorm(p0["ln1"], embed(params["embed"], toks, dt), cfg.rms_eps)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        kernel_ms[s] = flash_model_case(torch, card, rows, "lm", f"{LM_ARCH} lm prefill", cfg,
                                        attn.gqa_qkv(p0["attn"], h, cfg, positions),
                                        cfg.n_layers * nb, label)
    torch.cuda.empty_cache()

    # Timed: each queue served again (the same tokens), wall clock around
    # serve_queue, CUDA events around each prefill and decode step.
    weight_cast_ms = time_ms(lambda: [t.to(dt) for t in tree_leaves(params)], reps=2, batches=3)
    for eng, queue, (label, n, plen, batch, max_new, max_len) in zip(engines, queues, LM_QUEUES):
        again = [Request(prompt=r.prompt, max_new=r.max_new) for r in queue]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve_queue(again)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = tap.take()
        if [r.out for r in again] != [r.out for r in queue]:
            raise AssertionError(f"lm {label}: the same queue served again gave other tokens")
        prefill_ms = [ms for _, ms in calls["prefill"]]
        decode_ms = [ms for _, ms in calls["decode"]]
        tokens = sum(len(r.out) for r in again)
        emit({"phase": "lm", "call": "serve", "queue": label, "requests": n, "prompt_len": plen,
              "batch": batch, "max_new": max_new, "max_len": max_len, "tokens": tokens,
              "wall_s": wall, "tokens_per_s": tokens / wall, "lane_batches": len(prefill_ms),
              "prefill_ms": prefill_ms,
              # a decode step gives the next token of every request in the batch
              "decode_ms_per_token_median": statistics.median(decode_ms),
              "decode_ms_per_token_range": [min(decode_ms), max(decode_ms)],
              "decode_wall_ms_per_token": (wall * 1e3 - sum(prefill_ms)) / len(decode_ms),
              "kernel_ms": kernel_ms[plen],
              "kernel_share_of_prefill": cfg.n_layers * kernel_ms[plen]
              / statistics.median(prefill_ms),
              "weight_cast_ms": weight_cast_ms, "card": card})

    # The card against itself: decode after a prefill of s tokens against
    # the prefill of s + 1 (the next token being the one served), at bf16
    # beside the reference's function as the prefill attention, and at
    # float32 on the same weights; the first served token is the argmax of
    # the prefill's last logits.
    model32 = build(cfg.scaled(compute_dtype="float32"))
    for queue, (label, _, s, b, _, max_len) in zip(queues, LM_QUEUES):
        toks = torch.from_numpy(np.stack([np.append(r.prompt, r.out[0]) for r in queue[:b]])
                                .astype(np.int32)).to(dev)
        dec, full, pre = lm_golden(torch, model, params, toks, max_len)
        finite = all(bool(torch.isfinite(x).all()) for x in (full, pre, dec))
        first = torch.argmax(pre, -1).tolist() == [r.out[0] for r in queue[:b]]
        with reference_attention(attn):
            r_dec, r_full, _ = lm_golden(torch, model, params, toks, max_len)
        f_dec, f_full, _ = lm_golden(torch, model32, params, toks, max_len)
        line = {"phase": "lm", "check": "decode vs prefill", "lane": label, "s": s,
                "rel_err": rel_err(dec, full), "reference_attention_rel_err": rel_err(r_dec, r_full),
                "factor": LM_BF16_FACTOR, "ceiling": LM_BF16_CEILING,
                "float32_rel_err": rel_err(f_dec, f_full), "float32_tolerance": TOL_LM_F32_GOLDEN,
                "argmax_agree": float((dec.argmax(-1) == full.argmax(-1)).float().mean()),
                "first_token_is_prefill_argmax": first, "finite": finite}
        emit(line)
        if not (finite and first and line["float32_rel_err"] <= TOL_LM_F32_GOLDEN
                and line["rel_err"] <= LM_BF16_CEILING
                and line["rel_err"] <= LM_BF16_FACTOR * line["reference_attention_rel_err"]):
            raise AssertionError(f"lm {label}: {line}")
        del dec, full, pre, r_dec, r_full, f_dec, f_full
    peak = torch.cuda.max_memory_allocated()
    n_flash = launches["flash_attention_fwd"]
    del engines, eng, tap, params
    torch.cuda.empty_cache()

    # The card against the CPU at float32 compute, 2 layers at full width,
    # the same weights on both (the CPU runs the plain twins).
    cfg2 = cfg.scaled(n_layers=LM_CHECK_LAYERS, compute_dtype="float32")
    m2 = build(cfg2)
    p2 = m2.init(torch.Generator(device=dev).manual_seed(1))
    c2 = tree_map(lambda t: t.cpu(), p2)
    prompts = [r.prompt for r in queues[0][:LM_QUEUES[0][3]]]
    b, s = len(prompts), len(prompts[0])
    toks = torch.from_numpy(np.stack(prompts)).to(dev)
    logits, _, _ = lm_forward(p2, toks, cfg2)
    ref, _, _ = lm_forward(c2, toks.cpu(), cfg2)
    forward_err = rel_err(logits.cpu(), ref)
    _, caches = m2.prefill_fn(p2, {"tokens": toks[:, :-1]},
                              m2.init_cache_fn(b, 128, torch.float32, dev))
    _, c_caches = m2.prefill_fn(c2, {"tokens": toks[:, :-1].cpu()},
                                m2.init_cache_fn(b, 128, torch.float32, "cpu"))
    dec, _ = m2.decode_fn(p2, toks[:, -1:], s - 1, caches)
    dec_ref, _ = m2.decode_fn(c2, toks[:, -1:].cpu(), s - 1, c_caches)
    decode_err = rel_err(dec.cpu(), dec_ref)
    card_out = ServeEngine(m2, p2, batch=b, max_len=128).serve_queue(
        [Request(prompt=p, max_new=LM_CHECK_NEW) for p in prompts])
    cpu_out = ServeEngine(m2, c2, batch=b, max_len=128).serve_queue(
        [Request(prompt=p, max_new=LM_CHECK_NEW) for p in prompts])
    parted = []
    for i, (x, y) in enumerate(zip(card_out, cpu_out)):
        t = next((j for j, (u, w) in enumerate(zip(x.out, y.out)) if u != w), None)
        if t is not None:  # the CPU's top-2 margin where the two part
            seq = torch.from_numpy(np.append(prompts[i], y.out[:t]).astype(np.int32))[None]
            last, _ = m2.prefill_fn(c2, {"tokens": seq},
                                    m2.init_cache_fn(1, 128, torch.float32, "cpu"))
            top = torch.topk(last[0], 2).values
            parted.append({"request": i, "step": t,
                           "margin": float(top[0] - top[1]),
                           "tolerance": TOL_LM_CPU * float(last.abs().max())})
    line = {"phase": "lm", "check": "card vs cpu", "layers": LM_CHECK_LAYERS,
            "compute_dtype": "float32", "forward_rel_err": forward_err,
            "decode_rel_err": decode_err, "tolerance": TOL_LM_CPU,
            "tokens_equal": [x.out == y.out for x, y in zip(card_out, cpu_out)],
            "parted": parted, "peak_gb": peak / 1e9,
            "phase_seconds": time.perf_counter() - phase_t0, "card": card}
    emit(line)
    if not (forward_err <= TOL_LM_CPU and decode_err <= TOL_LM_CPU
            and all(pt["margin"] <= pt["tolerance"] for pt in parted)):
        raise AssertionError(f"lm card vs cpu: {line}")
    del p2, c2, caches, logits, dec
    torch.cuda.empty_cache()
    return n_flash


@contextlib.contextmanager
def reference_scan(xlstm):
    """The xLSTM prefill's sLSTM as the reference's model runs it, the plain
    step loop (``slstm_scan_plain``, the ``lax.scan`` of ``_slstm_step``),
    on the card's tensors: a yardstick, which launches nothing."""
    from repro_torch.kernels.slstm_scan import slstm_scan_plain

    route = xlstm.slstm_scan
    xlstm.slstm_scan = lambda xg, wr, bias, c, n, h, m, chunk: slstm_scan_plain(
        xg, wr, bias, c, n, h, m)
    try:
        yield
    finally:
        xlstm.slstm_scan = route


def lm_state_phase(torch, card: str, rows) -> dict:
    """repro_torch's LM serving of the recurrent-state families at full
    width, one arch after the other; returns the kernels' launches of the
    serving runs."""
    import gc

    launches = {"slstm_scan": 0, "flash_attention_fwd": 0}
    for arch, kernel, per_prefill, check_layers in LM_STATE_ARCHS:
        # The previous model's weights and caches go first: a ServeEngine
        # and its loop hold each other (bound methods), so only the cyclic
        # collector frees them.
        gc.collect()
        torch.cuda.empty_cache()
        launches[kernel] += lm_state_arch(torch, card, rows, arch, kernel, per_prefill,
                                          check_layers)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def slstm_model_case(torch, card, rows, cfg, params, toks, launches: int):
    """slstm_scan on layer 0's own gate pre-activations of a lane (embed,
    the pre-norm, mLSTM layer 0, the residual, the pre-norm, x @ wx) from
    the initial state, held to its plain version over every window, timed
    beside it; returns its ms."""
    from repro_torch.kernels.slstm_scan import slstm_scan, slstm_scan_plain
    from repro_torch.models import xlstm
    from repro_torch.models.layers import embed
    from repro_torch.models.param import tree_map
    from repro_torch.models.transformer import rmsnorm_like

    dt = getattr(torch, cfg.compute_dtype)
    b, l = toks.shape
    d = cfg.d_model
    x = embed(params["embed"], toks, dt)
    dm, _ = xlstm.mlstm_apply(tree_map(lambda t: t[0], params["mlstm_layers"]),
                              rmsnorm_like(x, cfg), cfg)
    x = x + dm
    p0 = tree_map(lambda t: t[0], params["slstm_layers"])
    xg = torch.matmul(rmsnorm_like(x, cfg).float(), p0["wx"].float())
    w = {"wr": p0["wr"].float(), "bias": p0["bias"].float()}
    st = xlstm.slstm_state(cfg, b, device=xg.device)
    state = (st["c"], st["n"], st["h"], st["m"])
    hs, final = slstm_scan(xg, w["wr"], w["bias"], *state, chunk=l)
    errs, plain_errs, abs_err = slstm_windows(torch, xg, w, state, hs)
    finite = bool(torch.isfinite(hs).all()) and all(bool(torch.isfinite(t).all()) for t in final)
    h_max = float(hs.abs().max())
    line = {"phase": "lm state", "kernel": "slstm_scan", "case": f"{cfg.name} slstm prefill",
            "shape": list(xg.shape), "window": SLSTM_WINDOW, "rel_err": errs,
            "plain_vs_float64_rel_err": plain_errs, "max_abs_err": abs_err, "finite": finite,
            "max_abs_h": h_max,
            "ms": time_ms(lambda: slstm_scan(xg, w["wr"], w["bias"], *state, chunk=l),
                          reps=5, batches=3),
            "plain_ms": time_ms(lambda: slstm_scan_plain(xg, w["wr"], w["bias"], *state),
                                reps=1, batches=3),
            "library_ms": None, "launches": launches, "card": card}
    cost = slstm_work(xg, w)
    line.update(cost._asdict())
    line["bound_ms"], line["bound_by"] = bound(card, cost)
    line["ms_per_step"] = line["ms"] / l
    emit(line)
    check_slstm_windows(f"slstm_scan on {cfg.name}'s layer-0 operands", errs, plain_errs,
                        finite, h_max)
    row = rows["slstm_scan"]
    row.setdefault("by_case", {})[f"{cfg.name} slstm prefill S={l}"] = {
        "rel_err": max(errs.values()),
        **{key: line[key] for key in ("shape", "ms", "ms_per_step", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "launches")}}
    row["max_abs_err"] = max(row["max_abs_err"], abs_err)
    row["rel_err"] = max(row["rel_err"], max(errs.values()))
    return line["ms"]


def float64_attention(fa, q, k, v, causal: bool, window=None, q_scale: float = 1.0,
                      budget: int = 1 << 30):
    """``mha_reference`` in float64 on (q·q_scale, k, v), a few batch-heads
    at a time, so that each (BH, Sq, Sk) score block stays within
    ``budget`` bytes."""
    import torch

    q, k, v = q.double() * q_scale, k.double(), v.double()
    step = max(1, budget // (8 * q.shape[1] * k.shape[1]))
    return torch.cat([fa.mha_reference(q[i:i + step], k[i:i + step], v[i:i + step],
                                       causal=causal, window=window)
                      for i in range(0, q.shape[0], step)])


def sdpa_ms(torch, q, k, v, causal: bool, window=None):
    """CUDA-event ms of ``scaled_dot_product_attention`` on (BH, Sq, D) x
    (BH, Sk, D) x (BH, Sk, Dv) at scale 1 (a window as a boolean mask), or
    None where no backend takes the shapes."""
    import torch.nn.functional as F

    kw = {"is_causal": causal}
    if window is not None:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        kw = {"attn_mask": (kpos > qpos - window) & ((kpos <= qpos) if causal else True)}
    try:
        return time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                              scale=1.0, **kw))
    except RuntimeError:
        return None


def flash_model_case(torch, card, rows, phase: str, case: str, cfg, qkv, launches: int,
                     lane: str, causal: bool = True, window=None):
    """flash_attention_fwd at a prefill's shape (B·H, S, D) (cross-attention:
    Sq queries against Sk keys; v of Dv, as MLA's), as the card route calls
    it (q scaled first, scale 1, the config's blocks and window): seeded
    Gaussian operands (k and v from the model's kv heads) against its plain
    version at 2e-5, and the model's own q, k, v (``qkv``, (B, S, H, D),
    rotated where the model rotates them) against float64, within
    LM_FLOAT64_FACTOR of the plain version's distance; timed beside its
    plain version and SDPA. One line; the case joins the ``kernels`` line's
    flash row. Returns its ms."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn

    mq, mk, mv = qkv
    dev = mq.device
    b, s, h, dh = mq.shape
    sk, dv = mk.shape[1], mv.shape[-1]
    opts = {"causal": causal, "window": window, "block_q": cfg.attn_block_q,
            "block_k": cfg.attn_block_k}
    gen = torch.Generator(device=dev).manual_seed(3)
    q, kk, v = attn.gqa_to_heads(
        torch.randn(b, s, h, dh, generator=gen, device=dev) / math.sqrt(dh),
        torch.randn(b, sk, mk.shape[2], dh, generator=gen, device=dev),
        torch.randn(b, sk, mk.shape[2], dv, generator=gen, device=dev))
    got = fa.flash_attention_fwd(q, kk, v, scale=1.0, **opts)
    ref = fa.flash_attention_plain(q, kk, v, scale=1.0, **opts)
    mq, mk, mv = attn.gqa_to_heads(mq * (1.0 / math.sqrt(dh)), mk, mv)
    m_got = fa.flash_attention_fwd(mq, mk, mv, scale=1.0, **opts)
    m_ref = fa.flash_attention_plain(mq, mk, mv, scale=1.0, **opts)
    m64 = float64_attention(fa, mq, mk, mv, causal, window, q_scale=math.sqrt(dh))
    torch.cuda.synchronize()
    cost = fa.fwd_cost(q.shape[0], s, sk, dh, dv, causal=causal, window=window)
    line = {"phase": phase, "kernel": "flash_attention_fwd", "case": case, "lane": lane,
            "shape": list(q.shape), "keys": sk, "value_dim": dv, "causal": causal,
            "window": window, "blocks": {k: opts[k] for k in ("block_q", "block_k")},
            "rel_err": rel_err(got, ref), "max_abs_err": max_abs(got, ref),
            "model_operands": {"rel_err_vs_plain": rel_err(m_got, m_ref),
                               "rel_err_vs_float64": rel_err(m_got, m64),
                               "plain_rel_err_vs_float64": rel_err(m_ref, m64),
                               # the init's scores, q k / sqrt(D)
                               "max_abs_score": float(max(
                                   (mq[i:i + 8] @ mk[i:i + 8].transpose(1, 2)).abs().max()
                                   for i in range(0, mq.shape[0], 8)))},
            "ms": time_ms(lambda: fa.flash_attention_fwd(q, kk, v, scale=1.0, **opts)),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, kk, v, scale=1.0, **opts),
                                reps=2, batches=3),
            "library_ms": sdpa_ms(torch, q, kk, v, causal, window),
            **cost._asdict(), "launches": launches, "card": card}
    line["bound_ms"], line["bound_by"] = bound(card, cost, split_tf32_rate(card))
    emit(line)
    del m64
    model_ops = line["model_operands"]
    if not line["rel_err"] <= TOL_KERNEL:
        raise AssertionError(f"flash_attention_fwd at {case} ({lane}): rel err "
                             f"{line['rel_err']} > {TOL_KERNEL}")
    if not model_ops["rel_err_vs_float64"] <= max(
            TOL_KERNEL, LM_FLOAT64_FACTOR * model_ops["plain_rel_err_vs_float64"]):
        raise AssertionError(f"flash_attention_fwd on the operands of {case}: {model_ops}")
    row = rows["flash_attention_fwd"]
    row["by_case"][f"{case} S={s}" if s == sk else f"{case} S={s}->{sk}"] = {
        key: line[key] for key in ("shape", "keys", "value_dim", "causal", "window", "rel_err",
                                   "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "launches")}
    row["max_abs_err"] = max(row["max_abs_err"], line["max_abs_err"])
    row["rel_err"] = max(row["rel_err"], line["rel_err"])
    return line["ms"]


def zamba2_qkv(torch, cfg, params, toks):
    """The first shared-block invocation's own q, k, v on ``toks``: embed,
    the first group of Mamba2 layers, concat with the embeddings, ln1."""
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.param import tree_map
    from repro_torch.models.transformer import _n_shared_invocations, _shared_block_cfg

    dt = getattr(torch, cfg.compute_dtype)
    b, s = toks.shape
    x0 = x = embed(params["embed"], toks, dt)
    for i in range(cfg.n_layers // _n_shared_invocations(cfg)):
        x, _ = ssm.mamba2_apply(tree_map(lambda t: t[i], params["mamba_layers"]), x, cfg)
    h = rmsnorm(params["shared"]["ln1"], torch.cat([x, x0], dim=-1), cfg.rms_eps)
    positions = torch.arange(s, device=toks.device)[None].expand(b, s)
    return attn.gqa_qkv(params["shared"]["attn"], h, _shared_block_cfg(cfg), positions)


def lm_state_arch(torch, card: str, rows, arch: str, kernel: str, per_prefill: int,
                  check_layers: int) -> int:
    """One recurrent-state arch through ServeEngine at full width, as
    lm_phase drives llama3.2-3b; returns ``kernel``'s launches of the
    serving run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm
    from repro_torch.models.build import build
    from repro_torch.models.param import param_bytes, tree_map
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config(arch)
    model = build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    t0 = phase_t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": "lm state", "call": "init", "arch": cfg.name, "family": cfg.family,
          "allocated_gb_before": allocated_before / 1e9,
          "n_params": model.n_params, "param_bytes": param_bytes(model.skeleton),
          "seconds": time.perf_counter() - t0, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "vocab": cfg.vocab, "compute_dtype": cfg.compute_dtype,
          "kernel": kernel, "card": card})

    # Serve both queues with the counts set to 0 just before and read just
    # after: every lane batch's prefill launches the kernel per_prefill
    # times, a decode step never; no other kernel runs.
    tap = LmTap(torch, model, kernel)
    engines = [ServeEngine(tap.model, params, batch=batch, max_len=max_len, dtype=torch.float32)
               for _, _, _, batch, _, max_len in LM_QUEUES]
    queues = [lm_queue(cfg, n, plen, max_new) for _, n, plen, _, max_new, _ in LM_QUEUES]
    torch.cuda.synchronize()
    reset_launches()
    for eng, queue in zip(engines, queues):
        eng.serve_queue(queue)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    counted = tap.take()
    lane_batches = [-(-n // batch) for _, n, _, batch, _, _ in LM_QUEUES]
    per_call = [n for n, _ in counted["prefill"]]
    per_decode = [n for n, _ in counted["decode"]]
    others = {name: n for name, n in launches.items() if n and name != kernel}
    emit({"phase": "lm state", "call": "launches", "arch": cfg.name, kernel: launches[kernel],
          "lane_batches": sum(lane_batches), "per_prefill": per_call,
          "decode_steps": len(per_decode), "decode_launches": sum(per_decode), "others": others})
    if (per_call != [per_prefill] * sum(lane_batches) or any(per_decode) or others
            or launches[kernel] != per_prefill * sum(lane_batches)):
        raise AssertionError(f"lm state {cfg.name}: {kernel} launched {per_call} a prefill, "
                             f"{sum(per_decode)} on decode steps, others {others}")
    for queue, (label, _, _, _, max_new, _) in zip(queues, LM_QUEUES):
        if not all(r.done and len(r.out) == max_new and all(0 <= t < cfg.vocab for t in r.out)
                   for r in queue):
            raise AssertionError(f"lm state {cfg.name} {label}: a request was not served in full")

    # The kernel on the model's own operands at each lane's shape.
    kernel_ms = {}
    for queue, nb, (label, _, s, b, _, _) in zip(queues, lane_batches, LM_QUEUES):
        toks = torch.from_numpy(np.stack([r.prompt for r in queue[:b]])).to(dev)
        if kernel == "slstm_scan":
            kernel_ms[s] = slstm_model_case(torch, card, rows, cfg, params, toks, per_prefill * nb)
        else:
            kernel_ms[s] = flash_model_case(torch, card, rows, "lm state",
                                            f"{cfg.name} shared block prefill", cfg,
                                            zamba2_qkv(torch, cfg, params, toks),
                                            per_prefill * nb, label)
    torch.cuda.empty_cache()

    # Timed: each queue served again (the same tokens), wall clock around
    # serve_queue, CUDA events around each prefill and decode step.
    for eng, queue, (label, n, plen, batch, max_new, max_len) in zip(engines, queues, LM_QUEUES):
        again = [Request(prompt=r.prompt, max_new=r.max_new) for r in queue]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve_queue(again)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = tap.take()
        if [r.out for r in again] != [r.out for r in queue]:
            raise AssertionError(f"lm state {cfg.name} {label}: the same queue served again "
                                 "gave other tokens")
        prefill_ms = [ms for _, ms in calls["prefill"]]
        decode_ms = [ms for _, ms in calls["decode"]]
        tokens = sum(len(r.out) for r in again)
        emit({"phase": "lm state", "call": "serve", "arch": cfg.name, "queue": label,
              "requests": n, "prompt_len": plen, "batch": batch, "max_new": max_new,
              "max_len": max_len, "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
              "lane_batches": len(prefill_ms), "prefill_ms": prefill_ms,
              "launches_per_prefill": per_prefill, "launches_per_decode_step": 0,
              # a decode step gives the next token of every request in the batch
              "decode_ms_per_token_median": statistics.median(decode_ms),
              "decode_ms_per_token_range": [min(decode_ms), max(decode_ms)],
              "decode_wall_ms_per_token": (wall * 1e3 - sum(prefill_ms)) / len(decode_ms),
              "kernel_ms": kernel_ms[plen],
              "kernel_share_of_prefill": per_prefill * kernel_ms[plen]
              / statistics.median(prefill_ms),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})

    # The card against itself: decode after a prefill of s tokens against
    # the prefill of s + 1. At full depth these models amplify a rounding
    # (see LM_STATE_ARCHS), so the two, which round the first s positions
    # in products of other shapes, part at O(0.1-1) of the largest logit
    # even at float32: the full-depth gaps are printed beside the
    # reference route's (the plain step loop / flash_attention_blocks) and
    # held only to be finite with the first served token the prefill's
    # argmax; the gate (float32, 2e-3) is held on the card-against-CPU
    # copy's depth, on the same weights.
    def yardstick():
        return reference_scan(xlstm) if kernel == "slstm_scan" else reference_attention(attn)

    model32 = build(cfg.scaled(compute_dtype="float32"))
    cut32 = build(cfg.scaled(n_layers=check_layers, compute_dtype="float32"))
    for queue, (label, _, s, b, _, max_len) in zip(queues, LM_QUEUES):
        toks = torch.from_numpy(np.stack([np.append(r.prompt, r.out[0]) for r in queue[:b]])
                                .astype(np.int32)).to(dev)
        dec, full, pre = lm_golden(torch, model, params, toks, max_len)
        finite = all(bool(torch.isfinite(x).all()) for x in (full, pre, dec))
        first = torch.argmax(pre, -1).tolist() == [r.out[0] for r in queue[:b]]
        with yardstick():
            r_dec, r_full, _ = lm_golden(torch, model, params, toks, max_len)
        f_dec, f_full, _ = lm_golden(torch, model32, params, toks, max_len)
        with yardstick():
            fr_dec, fr_full, _ = lm_golden(torch, model32, params, toks, max_len)
        c_dec, c_full, _ = lm_golden(torch, cut32, params, toks, max_len)
        line = {"phase": "lm state", "check": "decode vs prefill", "arch": cfg.name,
                "lane": label, "s": s, "bf16_rel_err": rel_err(dec, full),
                "bf16_reference_route_rel_err": rel_err(r_dec, r_full),
                "float32_rel_err": rel_err(f_dec, f_full),
                "float32_reference_route_rel_err": rel_err(fr_dec, fr_full),
                "argmax_agree": float((dec.argmax(-1) == full.argmax(-1)).float().mean()),
                "first_token_is_prefill_argmax": first, "finite": finite,
                "cut_layers": check_layers, "cut_float32_rel_err": rel_err(c_dec, c_full),
                "cut_float32_tolerance": TOL_LM_F32_GOLDEN}
        emit(line)
        if not (finite and first and line["cut_float32_rel_err"] <= TOL_LM_F32_GOLDEN):
            raise AssertionError(f"lm state {cfg.name} {label}: {line}")
        del dec, full, pre, r_dec, r_full, f_dec, f_full, fr_dec, fr_full, c_dec, c_full
    peak = torch.cuda.max_memory_allocated()
    n_launched = launches[kernel]
    del engines, eng, tap, params
    torch.cuda.empty_cache()

    # The card against the CPU at float32 compute, cut in depth only, the
    # same weights on both (the CPU runs the plain versions).
    cfg2 = cfg.scaled(n_layers=check_layers, compute_dtype="float32")
    m2 = build(cfg2)
    forward = T.xlstm_forward if cfg.family == "ssm" else T.hybrid_forward
    p2 = m2.init(torch.Generator(device=dev).manual_seed(1))
    c2 = tree_map(lambda t: t.cpu(), p2)
    prompts = [r.prompt for r in queues[0][:LM_QUEUES[0][3]]]
    b, s = len(prompts), len(prompts[0])
    toks = torch.from_numpy(np.stack(prompts)).to(dev)
    logits, _, _ = forward(p2, toks, cfg2)
    ref, _, _ = forward(c2, toks.cpu(), cfg2)
    forward_err = rel_err(logits.cpu(), ref)
    _, caches = m2.prefill_fn(p2, {"tokens": toks[:, :-1]},
                              m2.init_cache_fn(b, 128, torch.float32, dev))
    _, c_caches = m2.prefill_fn(c2, {"tokens": toks[:, :-1].cpu()},
                                m2.init_cache_fn(b, 128, torch.float32, "cpu"))
    dec, _ = m2.decode_fn(p2, toks[:, -1:], s - 1, caches)
    dec_ref, _ = m2.decode_fn(c2, toks[:, -1:].cpu(), s - 1, c_caches)
    decode_err = rel_err(dec.cpu(), dec_ref)
    card_out = ServeEngine(m2, p2, batch=b, max_len=128).serve_queue(
        [Request(prompt=p, max_new=LM_CHECK_NEW) for p in prompts])
    cpu_out = ServeEngine(m2, c2, batch=b, max_len=128).serve_queue(
        [Request(prompt=p, max_new=LM_CHECK_NEW) for p in prompts])
    parted = []
    for i, (x, y) in enumerate(zip(card_out, cpu_out)):
        t = next((j for j, (u, w) in enumerate(zip(x.out, y.out)) if u != w), None)
        if t is not None:  # the CPU's top-2 margin where the two part
            seq = torch.from_numpy(np.append(prompts[i], y.out[:t]).astype(np.int32))[None]
            last, _ = m2.prefill_fn(c2, {"tokens": seq},
                                    m2.init_cache_fn(1, 128, torch.float32, "cpu"))
            top = torch.topk(last[0], 2).values
            parted.append({"request": i, "step": t, "margin": float(top[0] - top[1]),
                           "tolerance": TOL_LM_CPU * float(last.abs().max())})
    line = {"phase": "lm state", "check": "card vs cpu", "arch": cfg.name,
            "layers": check_layers, "compute_dtype": "float32", "forward_rel_err": forward_err,
            "decode_rel_err": decode_err, "tolerance": TOL_LM_CPU,
            "tokens_equal": [x.out == y.out for x, y in zip(card_out, cpu_out)],
            "parted": parted, "peak_gb": peak / 1e9,
            "phase_seconds": time.perf_counter() - phase_t0, "card": card}
    emit(line)
    if not (forward_err <= TOL_LM_CPU and decode_err <= TOL_LM_CPU
            and all(pt["margin"] <= pt["tolerance"] for pt in parted)):
        raise AssertionError(f"lm state {cfg.name} card vs cpu: {line}")
    del p2, c2, caches, logits, dec
    torch.cuda.empty_cache()
    return n_launched


def lm_audio_phase(torch, card, rows) -> int:
    """repro_torch's LM serving of the audio family at whisper-medium's full
    width; returns the ``flash_attention_fwd`` launches of the serving run."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import frames_for
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T
    from repro_torch.models.build import build
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.param import param_bytes, tree_leaves, tree_map
    from repro_torch.serve import Request, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config(AUDIO_ARCH)
    n_enc = cfg.n_enc_layers or cfg.n_layers
    per_prefill, per_step = n_enc + 2 * cfg.n_layers, cfg.n_layers
    model = build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    t0 = phase_t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": "lm audio", "call": "init", "arch": cfg.name, "family": cfg.family,
          "allocated_gb_before": allocated_before / 1e9, "n_params": model.n_params,
          "param_bytes": param_bytes(model.skeleton), "seconds": time.perf_counter() - t0,
          "enc_layers": n_enc, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab,
          "enc_frames": cfg.enc_frames, "compute_dtype": cfg.compute_dtype, "card": card})

    # Serve both queues with the counts set to 0 just before and read just
    # after: every prefill launches the kernel per_prefill times, every
    # decode step per_step times; no other kernel runs.
    tap = LmTap(torch, model)
    engines = [ServeEngine(tap.model, params, batch=batch, max_len=max_len, dtype=torch.float32)
               for _, _, _, batch, _, max_len in AUDIO_QUEUES]
    cross_bytes = sum(t.numel() * t.element_size() for key in ("cross_k", "cross_v")
                      for t in tree_leaves(engines[0].caches["dec"][key]))
    frames = frames_for(cfg, AUDIO_QUEUES[0][3], 0, device=dev)
    extras = {"frames": frames}
    queues = [lm_queue(cfg, n, plen, max_new) for _, n, plen, _, max_new, _ in AUDIO_QUEUES]
    torch.cuda.synchronize()
    reset_launches()
    for eng, queue in zip(engines, queues):
        eng.serve_queue(queue, extras=extras)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    counted = tap.take()
    lane_batches = [-(-n // batch) for _, n, _, batch, _, _ in AUDIO_QUEUES]
    steps = sum(nb * max_new for nb, (_, _, _, _, max_new, _) in zip(lane_batches, AUDIO_QUEUES))
    per_call = [n for n, _ in counted["prefill"]]
    per_decode = [n for n, _ in counted["decode"]]
    others = {name: n for name, n in launches.items() if n and name != "flash_attention_fwd"}
    emit({"phase": "lm audio", "call": "launches", "arch": cfg.name,
          "flash_attention_fwd": launches["flash_attention_fwd"],
          "lane_batches": sum(lane_batches), "per_prefill": per_call,
          "decode_steps": len(per_decode), "per_decode_step": sorted(set(per_decode)),
          "decode_launches": sum(per_decode), "others": others,
          "cross_kv_gb_per_row": cross_bytes / AUDIO_QUEUES[0][3] / 1e9, "frames": list(frames.shape)})
    if (per_call != [per_prefill] * sum(lane_batches) or per_decode != [per_step] * steps
            or others or launches["flash_attention_fwd"]
            != per_prefill * sum(lane_batches) + per_step * steps):
        raise AssertionError(f"lm audio: flash_attention_fwd launched {per_call} a prefill, "
                             f"{sorted(set(per_decode))} a decode step ({len(per_decode)} "
                             f"steps), others {others}")
    for queue, (label, _, _, _, max_new, _) in zip(queues, AUDIO_QUEUES):
        if not all(r.done and len(r.out) == max_new and all(0 <= t < cfg.vocab for t in r.out)
                   for r in queue):
            raise AssertionError(f"lm audio {label}: a request was not served in full")

    # The kernel on the model's own operands at each of its shapes: layer 0
    # of the encoder on the frames (B·H 64, 1500 positions, non-causal);
    # for each lane, decoder layer 0's self-attention (causal) and its
    # cross-attention over the encoder output (S queries, 1500 keys); a
    # decode step's cross-attention (one query, the last prompt position's).
    dt = getattr(torch, cfg.compute_dtype)
    b, t = frames.shape[0], frames.shape[1]
    p_enc = tree_map(lambda w: w[0], params["enc_layers"])
    p_dec = tree_map(lambda w: w[0], params["dec_layers"])
    enc_pos = torch.arange(t, device=dev)[None].expand(b, t)
    h = rmsnorm(p_enc["ln1"], frames.to(dt), cfg.rms_eps)
    enc_ms = flash_model_case(torch, card, rows, "lm audio", f"{cfg.name} encoder", cfg,
                              attn.gqa_qkv(p_enc["attn"], h, cfg, enc_pos),
                              n_enc * sum(lane_batches), "both queues", causal=False)
    kx, vx = attn.cross_kv(p_dec["xattn"], T.encoder_forward(params, frames, cfg), dt)
    prefill_kernel_ms, q_last = {}, None
    for queue, nb, (label, _, s, _, _, _) in zip(queues, lane_batches, AUDIO_QUEUES):
        toks = torch.from_numpy(np.stack([r.prompt for r in queue[:b]])).to(dev)
        x = embed(params["embed"], toks, dt)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        h = rmsnorm(p_dec["ln1"], x, cfg.rms_eps)
        self_ms = flash_model_case(torch, card, rows, "lm audio", f"{cfg.name} decoder self",
                                   cfg, attn.gqa_qkv(p_dec["attn"], h, cfg, positions),
                                   cfg.n_layers * nb, label)
        a, _ = attn.gqa_apply(p_dec["attn"], h, cfg, positions=positions)
        hx = rmsnorm(p_dec["lnx"], x + a, cfg.rms_eps)
        q = attn._project(hx, p_dec["xattn"]["wq"].to(dt))
        cross_ms = flash_model_case(torch, card, rows, "lm audio", f"{cfg.name} cross", cfg,
                                    (q, kx, vx), cfg.n_layers * nb, label, causal=False)
        prefill_kernel_ms[s] = n_enc * enc_ms + cfg.n_layers * (self_ms + cross_ms)
        q_last = q[:, -1:] if q_last is None else q_last
    step_ms = flash_model_case(torch, card, rows, "lm audio", f"{cfg.name} cross decode", cfg,
                               (q_last, kx, vx), per_step * steps, "both queues", causal=False)
    del h, kx, vx, q, q_last, a, hx, x
    torch.cuda.empty_cache()

    # Timed: each queue served again (the same tokens), wall clock around
    # serve_queue, CUDA events around each prefill and decode step.
    for eng, queue, (label, n, plen, batch, max_new, max_len) in zip(engines, queues,
                                                                      AUDIO_QUEUES):
        again = [Request(prompt=r.prompt, max_new=r.max_new) for r in queue]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve_queue(again, extras=extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = tap.take()
        if [r.out for r in again] != [r.out for r in queue]:
            raise AssertionError(f"lm audio {label}: the same queue served again gave other "
                                 "tokens")
        prefill_ms = [ms for _, ms in calls["prefill"]]
        decode_ms = [ms for _, ms in calls["decode"]]
        tokens = sum(len(r.out) for r in again)
        emit({"phase": "lm audio", "call": "serve", "arch": cfg.name, "queue": label,
              "requests": n, "prompt_len": plen, "batch": batch, "max_new": max_new,
              "max_len": max_len, "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
              "lane_batches": len(prefill_ms), "prefill_ms": prefill_ms,
              "launches_per_prefill": per_prefill, "launches_per_decode_step": per_step,
              # a decode step gives the next token of every request in the batch
              "decode_ms_per_token_median": statistics.median(decode_ms),
              "decode_ms_per_token_range": [min(decode_ms), max(decode_ms)],
              "decode_wall_ms_per_token": (wall * 1e3 - sum(prefill_ms)) / len(decode_ms),
              "kernel_ms_per_prefill": prefill_kernel_ms[plen],
              "kernel_share_of_prefill": prefill_kernel_ms[plen] / statistics.median(prefill_ms),
              "kernel_ms_per_decode_step": per_step * step_ms,
              "kernel_share_of_decode_step": per_step * step_ms / statistics.median(decode_ms),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})

    # The card against itself: decode after a prefill of s tokens against
    # the prefill of s + 1 (the next token being the one served). At full
    # depth (48 layers) whisper amplifies a rounding as the recurrent-state
    # models do (see AUDIO_QUEUES), so the full-depth gaps, bf16 and
    # float32, are printed beside the reference's function as the attention
    # (``flash_attention_blocks``) and held finite with the first served
    # token the prefill's argmax; the gate (float32, 2e-3) is held on the
    # card-against-CPU copy's depth, on the same weights.
    model32 = build(cfg.scaled(compute_dtype="float32"))
    cut32 = build(cfg.scaled(n_layers=AUDIO_CHECK_LAYERS, n_enc_layers=AUDIO_CHECK_LAYERS,
                             compute_dtype="float32"))
    for queue, (label, _, s, b, _, max_len) in zip(queues, AUDIO_QUEUES):
        toks = torch.from_numpy(np.stack([np.append(r.prompt, r.out[0]) for r in queue[:b]])
                                .astype(np.int32)).to(dev)
        dec, full, pre = lm_golden(torch, model, params, toks, max_len, extras)
        finite = all(bool(torch.isfinite(x).all()) for x in (full, pre, dec))
        first = torch.argmax(pre, -1).tolist() == [r.out[0] for r in queue[:b]]
        with reference_attention(attn):
            r_dec, r_full, _ = lm_golden(torch, model, params, toks, max_len, extras)
        f_dec, f_full, _ = lm_golden(torch, model32, params, toks, max_len, extras)
        with reference_attention(attn):
            fr_dec, fr_full, _ = lm_golden(torch, model32, params, toks, max_len, extras)
        c_dec, c_full, _ = lm_golden(torch, cut32, params, toks, max_len, extras)
        line = {"phase": "lm audio", "check": "decode vs prefill", "arch": cfg.name,
                "lane": label, "s": s, "bf16_rel_err": rel_err(dec, full),
                "bf16_reference_route_rel_err": rel_err(r_dec, r_full),
                "float32_rel_err": rel_err(f_dec, f_full),
                "float32_reference_route_rel_err": rel_err(fr_dec, fr_full),
                "argmax_agree": float((dec.argmax(-1) == full.argmax(-1)).float().mean()),
                "first_token_is_prefill_argmax": first, "finite": finite,
                "cut_layers": AUDIO_CHECK_LAYERS, "cut_float32_rel_err": rel_err(c_dec, c_full),
                "cut_float32_tolerance": TOL_LM_F32_GOLDEN}
        emit(line)
        if not (finite and first and line["cut_float32_rel_err"] <= TOL_LM_F32_GOLDEN):
            raise AssertionError(f"lm audio {label}: {line}")
        del dec, full, pre, r_dec, r_full, f_dec, f_full, fr_dec, fr_full, c_dec, c_full
    peak = torch.cuda.max_memory_allocated()
    n_flash = launches["flash_attention_fwd"]
    del engines, eng, tap, params
    gc.collect()
    torch.cuda.empty_cache()

    # The card against the CPU at float32 compute, cut in depth only, the
    # same weights and frames on both (the CPU runs the plain twins).
    cfg2 = cfg.scaled(n_layers=AUDIO_CHECK_LAYERS, n_enc_layers=AUDIO_CHECK_LAYERS,
                      compute_dtype="float32")
    m2 = build(cfg2)
    p2 = m2.init(torch.Generator(device=dev).manual_seed(1))
    c2 = tree_map(lambda w: w.cpu(), p2)
    prompts = [r.prompt for r in queues[0][:AUDIO_QUEUES[0][3]]]
    b, s = len(prompts), len(prompts[0])
    toks = torch.from_numpy(np.stack(prompts)).to(dev)
    logits, _, _ = T.encdec_forward(p2, toks, cfg2, frames=frames)
    ref, _, _ = T.encdec_forward(c2, toks.cpu(), cfg2, frames=frames.cpu())
    forward_err = rel_err(logits.cpu(), ref)
    by_position = (logits.cpu() - ref).abs().amax(-1) / ref.abs().amax(-1)
    enc_err = rel_err(T.encoder_forward(p2, frames, cfg2).cpu(),
                      T.encoder_forward(c2, frames.cpu(), cfg2))
    with reference_attention(attn):
        r_logits, _, _ = T.encdec_forward(p2, toks, cfg2, frames=frames)
    noise = torch.randn(frames.shape, generator=torch.Generator(device=dev).manual_seed(9),
                        device=dev)
    nudged, _, _ = T.encdec_forward(p2, toks, cfg2, frames=frames * (1 + 1e-7 * noise))
    diag = {"positions": by_position.numel(),
            "positions_over_tolerance": int((by_position > TOL_LM_CPU).sum()),
            "median_position_rel_err": float(by_position.median()), "encoder_rel_err": enc_err,
            "reference_route_forward_rel_err": rel_err(r_logits.cpu(), ref),
            "route_factor": AUDIO_ROUTE_FACTOR,
            "card_change_at_1e-7_of_frames": rel_err(nudged, logits)}
    del r_logits, nudged, noise
    pre = {"tokens": toks[:, :-1], "frames": frames}
    _, caches = m2.prefill_fn(p2, pre, m2.init_cache_fn(b, 128, torch.float32, dev))
    _, c_caches = m2.prefill_fn(c2, {key: v.cpu() for key, v in pre.items()},
                                m2.init_cache_fn(b, 128, torch.float32, "cpu"))
    dec, _ = m2.decode_fn(p2, toks[:, -1:], s - 1, caches)
    dec_ref, _ = m2.decode_fn(c2, toks[:, -1:].cpu(), s - 1, c_caches)
    decode_err = rel_err(dec.cpu(), dec_ref)
    card_out = ServeEngine(m2, p2, batch=b, max_len=128).serve_queue(
        [Request(prompt=q, max_new=LM_CHECK_NEW) for q in prompts], extras=extras)
    cpu_out = ServeEngine(m2, c2, batch=b, max_len=128).serve_queue(
        [Request(prompt=q, max_new=LM_CHECK_NEW) for q in prompts],
        extras={"frames": frames.cpu()})
    parted = []
    for i, (x, y) in enumerate(zip(card_out, cpu_out)):
        t = next((j for j, (u, w) in enumerate(zip(x.out, y.out)) if u != w), None)
        if t is not None:  # the CPU's top-2 margin where the two part
            seq = torch.from_numpy(np.append(prompts[i], y.out[:t]).astype(np.int32))[None]
            last, _ = m2.prefill_fn(c2, {"tokens": seq, "frames": frames[i:i + 1].cpu()},
                                    m2.init_cache_fn(1, 128, torch.float32, "cpu"))
            top = torch.topk(last[0], 2).values
            parted.append({"request": i, "step": t, "margin": float(top[0] - top[1]),
                           "tolerance": TOL_LM_CPU * float(last.abs().max())})
    line = {"phase": "lm audio", "check": "card vs cpu", "arch": cfg.name,
            "enc_layers": AUDIO_CHECK_LAYERS, "layers": AUDIO_CHECK_LAYERS,
            "compute_dtype": "float32", "forward_rel_err": forward_err, **diag,
            "decode_rel_err": decode_err, "tolerance": TOL_LM_CPU,
            "tokens_equal": [x.out == y.out for x, y in zip(card_out, cpu_out)],
            "parted": parted, "peak_gb": peak / 1e9,
            "phase_seconds": time.perf_counter() - phase_t0, "card": card}
    emit(line)
    if not (forward_err <= max(TOL_LM_CPU, AUDIO_ROUTE_FACTOR
                               * diag["reference_route_forward_rel_err"])
            and decode_err <= TOL_LM_CPU
            and all(pt["margin"] <= pt["tolerance"] for pt in parted)):
        raise AssertionError(f"lm audio card vs cpu: {line}")
    del p2, c2, caches, logits, dec, card_out, cpu_out
    gc.collect()
    torch.cuda.empty_cache()
    return n_flash


class MoeTap:
    """While active, wraps ``repro_torch.models.moe.moe_apply`` (the stack
    calls it through the module): for each call its sequence length, its
    dispatch counts (capacity, kept and all assignments, as 0-d tensors),
    CUDA events around it where ``timed``, and its input and weights where
    ``inputs``. ``calls`` in order."""

    def __init__(self, torch, timed: bool = False, inputs: bool = False):
        self.torch, self.timed, self.inputs, self.calls = torch, timed, inputs, []

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe.moe_apply

        def run(p, x, cfg, **kw):
            stats = {}
            events = None
            if self.timed:
                events = (self.torch.cuda.Event(enable_timing=True),
                          self.torch.cuda.Event(enable_timing=True))
                events[0].record()
            out = self.route(p, x, cfg, stats=stats, **kw)
            if events:
                events[1].record()
            self.calls.append({"s": x.shape[1], "stats": stats, "events": events,
                               "x": x if self.inputs else None,
                               "p": p if self.inputs else None})
            return out

        moe.moe_apply = run
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.route

    def take(self):
        """{"prefill": [...], "decode": [...]} of the calls since the last
        take: (ms, assignments, kept) each."""
        self.torch.cuda.synchronize()
        out = {"prefill": [], "decode": []}
        for c in self.calls:
            ms = c["events"][0].elapsed_time(c["events"][1]) if c["events"] else None
            out["prefill" if c["s"] > 1 else "decode"].append(
                (ms, c["stats"]["assignments"], int(c["stats"]["kept"])))
        self.calls.clear()
        return out


def moe_params(torch, model, bf16_experts: bool, seed: int):
    """The model's weights from a card generator seeded ``seed``; the routed
    experts drawn and held in bf16 where ``bf16_experts``."""
    from repro_torch.models import moe
    from repro_torch.models.param import init_params

    skel = moe.with_expert_dtype(model.skeleton, torch.bfloat16) if bf16_experts \
        else model.skeleton
    return init_params(skel, torch.Generator(device="cuda").manual_seed(seed))


def moe_golden(torch, model, params, prompts, max_len: int):
    """Decode after a prefill of the prompts (B, s) against the prefill of
    s + 1, the next token being the prefill's argmax: (decode logits, the
    s + 1 prefill's last logits)."""
    b, s = prompts.shape
    dev = prompts.device
    pre, caches = model.prefill_fn(params, {"tokens": prompts},
                                   model.init_cache_fn(b, max_len, torch.float32, dev))
    nxt = torch.argmax(pre, -1).to(torch.int32)[:, None]
    dec, _ = model.decode_fn(params, nxt, s, caches)
    del caches
    full, _ = model.prefill_fn(params, {"tokens": torch.cat([prompts, nxt], 1)},
                               model.init_cache_fn(b, max_len, torch.float32, dev))
    return dec, full


def moe_cfg(cfg, layers: int, dense: int, experts=None, **moe_kw):
    """``cfg`` cut to ``layers`` with ``dense`` leading dense layers (and
    ``experts`` routed experts), its MoEConfig changed by ``moe_kw``."""
    import dataclasses

    m = dataclasses.replace(cfg.moe, n_dense_layers=dense, **moe_kw)
    if experts is not None:
        m = dataclasses.replace(m, n_experts=experts)
    return cfg.scaled(n_layers=layers, moe=m)


def lm_moe_phase(torch, card: str, rows) -> int:
    """repro_torch's LM serving of the moe family at full width, one arch
    after the other; returns the ``flash_attention_fwd`` launches of the
    serving runs."""
    import gc

    launches = 0
    for arch, layers, dense, bf16_experts, queues, golden, check in MOE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        launches += lm_moe_arch(torch, card, rows, arch, layers, dense, bf16_experts, queues,
                                golden, check)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def lm_moe_arch(torch, card: str, rows, arch: str, layers: int, dense: int, bf16_experts: bool,
                lane_specs, golden, check) -> int:
    """One moe arch through ServeEngine at full width, cut in depth, as
    lm_phase drives llama3.2-3b; returns the ``flash_attention_fwd``
    launches of its serving run."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models import attention as attn
    from repro_torch.models.build import build
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    full_cfg = get_config(arch)
    cfg = moe_cfg(full_cfg, layers, dense)
    m = cfg.moe
    model = build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    t0 = phase_t0 = time.perf_counter()
    params = moe_params(torch, model, bf16_experts, 0)
    torch.cuda.synchronize()
    emit({"phase": "lm moe", "call": "init", "arch": cfg.name, "family": cfg.family,
          "allocated_gb_before": allocated_before / 1e9, "n_params": model.n_params,
          "full_n_params": build(full_cfg).n_params,
          "param_gb": sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9,
          "expert_dtype": str(params["moe_layers"]["moe"]["wg"].dtype),
          "seconds": time.perf_counter() - t0, "layers": cfg.n_layers, "dense_layers": dense,
          "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "attention": cfg.attention, "window": cfg.sliding_window, "experts": m.n_experts,
          "top_k": m.top_k, "d_ff_expert": m.d_ff_expert, "shared_experts": m.n_shared_experts,
          "capacity_factor": m.capacity_factor, "mtp": cfg.mtp, "vocab": cfg.vocab,
          "compute_dtype": cfg.compute_dtype, "card": card})

    # Serve both queues with the counts set to 0 just before and read just
    # after: every lane batch's prefill launches the kernel once a layer,
    # a decode step never; no other kernel runs.
    tap = LmTap(torch, model)
    engines = [ServeEngine(tap.model, params, batch=batch, max_len=max_len, dtype=torch.float32)
               for _, _, _, batch, _, max_len in lane_specs]
    queues = [lm_queue(cfg, n, plen, max_new) for _, n, plen, _, max_new, _ in lane_specs]
    torch.cuda.synchronize()
    with MoeTap(torch) as moe_tap:
        reset_launches()
        for eng, queue in zip(engines, queues):
            eng.serve_queue(queue)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    counted = tap.take()
    dispatch = moe_tap.take()
    lane_batches = [-(-n // batch) for _, n, _, batch, _, _ in lane_specs]
    per_call = [n for n, _ in counted["prefill"]]
    per_decode = [n for n, _ in counted["decode"]]
    others = {name: n for name, n in launches.items() if n and name != "flash_attention_fwd"}
    assignments = sum(a for _, a, _ in dispatch["prefill"])
    dropped = assignments - sum(kept for _, _, kept in dispatch["prefill"])
    emit({"phase": "lm moe", "call": "launches", "arch": cfg.name,
          "flash_attention_fwd": launches["flash_attention_fwd"],
          "lane_batches": sum(lane_batches), "per_prefill": per_call,
          "decode_steps": len(per_decode), "decode_launches": sum(per_decode), "others": others,
          "prefill_assignments": assignments, "prefill_dropped": dropped,
          "dropped_share": dropped / assignments,
          "decode_dropped": sum(a - kept for _, a, kept in dispatch["decode"])})
    if (per_call != [cfg.n_layers] * sum(lane_batches) or any(per_decode) or others
            or launches["flash_attention_fwd"] != cfg.n_layers * sum(lane_batches)):
        raise AssertionError(f"lm moe {cfg.name}: flash_attention_fwd launched {per_call} a "
                             f"prefill, {sum(per_decode)} on decode steps, others {others}")
    if any(a != kept for _, a, kept in dispatch["decode"]):
        raise AssertionError(f"lm moe {cfg.name}: a decode step dropped an assignment")
    for queue, (label, _, _, _, max_new, _) in zip(queues, lane_specs):
        if not all(r.done and len(r.out) == max_new and all(0 <= t < cfg.vocab for t in r.out)
                   for r in queue):
            raise AssertionError(f"lm moe {cfg.name} {label}: a request was not served in full")

    # deepseek's loss_fn (xent, aux, the MTP loss) once under no_grad: the
    # layers' prefill attention, then the MTP block's.
    n_loss = 0
    if cfg.mtp:
        b, s = MOE_LOSS_BATCH
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (b, s))
                                .astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, metrics = model.loss_fn(params, {"tokens": toks})
        torch.cuda.synchronize()
        loss_s = time.perf_counter() - t0
        n_loss = LAUNCHES["flash_attention_fwd"]
        fired = {name: n for name, n in LAUNCHES.items() if n}
        line = {"phase": "lm moe", "call": "loss_fn", "arch": cfg.name, "batch": [b, s],
                "launches": fired, "metrics": {k: float(v) for k, v in metrics.items()},
                "seconds": loss_s, "card": card}
        emit(line)
        if fired != {"flash_attention_fwd": cfg.n_layers + 1} or not all(
                math.isfinite(v) for v in line["metrics"].values()):
            raise AssertionError(f"lm moe {cfg.name} loss_fn: {line}")
        del loss, metrics, toks

    # The kernel on each lane's shapes: Gaussian operands against its plain
    # version, and layer 0's own q, k, v (mixtral: GQA, rotated, the
    # window; deepseek: MLA's q and k of 192 against v of 128) against
    # float64.
    dt = getattr(torch, cfg.compute_dtype)
    stack = "dense_layers" if dense else "moe_layers"
    p0 = tree_map(lambda t: t[0], params[stack])
    kernel_ms = {}
    for queue, nb, (label, _, s, b, _, _) in zip(queues, lane_batches, lane_specs):
        toks = torch.from_numpy(np.stack([r.prompt for r in queue[:b]])).to(dev)
        h = rmsnorm(p0["ln1"], embed(params["embed"], toks, dt), cfg.rms_eps)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        if cfg.attention == "mla":
            qkv = attn.mla_qkv(p0["attn"], h, cfg, positions)[:3]
        else:
            qkv = attn.gqa_qkv(p0["attn"], h, cfg, positions)
        kernel_ms[s] = flash_model_case(torch, card, rows, "lm moe", f"{cfg.name} prefill",
                                        cfg, qkv, cfg.n_layers * nb, label,
                                        window=cfg.sliding_window)
        del qkv, h
    torch.cuda.empty_cache()

    # Timed: each queue served again (the same tokens), wall clock around
    # serve_queue, CUDA events around each prefill and decode step and
    # around each moe block.
    for eng, queue, (label, n, plen, batch, max_new, max_len) in zip(engines, queues,
                                                                     lane_specs):
        again = [Request(prompt=r.prompt, max_new=r.max_new) for r in queue]
        torch.cuda.synchronize()
        with MoeTap(torch, timed=True) as moe_tap:
            t0 = time.perf_counter()
            eng.serve_queue(again)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        calls = tap.take()
        blocks = moe_tap.take()
        if [r.out for r in again] != [r.out for r in queue]:
            raise AssertionError(f"lm moe {cfg.name} {label}: the same queue served again "
                                 "gave other tokens")
        prefill_ms = [ms for _, ms in calls["prefill"]]
        decode_ms = [ms for _, ms in calls["decode"]]
        tokens = sum(len(r.out) for r in again)
        emit({"phase": "lm moe", "call": "serve", "arch": cfg.name, "queue": label,
              "requests": n, "prompt_len": plen, "batch": batch, "max_new": max_new,
              "max_len": max_len, "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
              "lane_batches": len(prefill_ms), "prefill_ms": prefill_ms,
              "launches_per_prefill": cfg.n_layers, "launches_per_decode_step": 0,
              # a decode step gives the next token of every request in the batch
              "decode_ms_per_token_median": statistics.median(decode_ms),
              "decode_ms_per_token_range": [min(decode_ms), max(decode_ms)],
              "decode_wall_ms_per_token": (wall * 1e3 - sum(prefill_ms)) / len(decode_ms),
              "kernel_ms": kernel_ms[plen],
              "kernel_share_of_prefill": cfg.n_layers * kernel_ms[plen]
              / statistics.median(prefill_ms),
              "moe_share_of_prefill": sum(ms for ms, _, _ in blocks["prefill"]) / sum(prefill_ms),
              "moe_share_of_decode_step": sum(ms for ms, _, _ in blocks["decode"])
              / sum(decode_ms),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})

    # The card against itself: decode after a prefill of s tokens against
    # the prefill of s + 1, the first served token the prefill's argmax; at
    # bf16 (capacity factor 1.25: printed) and, on the served float32
    # weights, at float32 with capacity factor E / k (gated).
    for queue, (label, _, s, b, _, max_len) in zip(queues, lane_specs):
        toks = torch.from_numpy(np.stack([np.append(r.prompt, r.out[0]) for r in queue[:b]])
                                .astype(np.int32)).to(dev)
        dec, full, pre = lm_golden(torch, model, params, toks, max_len)
        line = {"phase": "lm moe", "check": "decode vs prefill", "arch": cfg.name,
                "lane": label, "s": s, "compute_dtype": "bfloat16",
                "capacity_factor": m.capacity_factor, "rel_err": rel_err(dec, full),
                "argmax_agree": float((dec.argmax(-1) == full.argmax(-1)).float().mean()),
                "first_token_is_prefill_argmax":
                    torch.argmax(pre, -1).tolist() == [r.out[0] for r in queue[:b]],
                "finite": all(bool(torch.isfinite(x).all()) for x in (full, pre, dec))}
        emit(line)
        if not (line["finite"] and line["first_token_is_prefill_argmax"]):
            raise AssertionError(f"lm moe {cfg.name} {label}: {line}")
        del dec, full, pre
    if golden:
        keep_all = build(moe_cfg(full_cfg, layers, dense, capacity_factor=m.n_experts / m.top_k)
                         .scaled(compute_dtype="float32"))
        for s, b in golden:
            lane = next(q for q, spec in zip(queues, lane_specs) if spec[2] == s)
            prompts = torch.from_numpy(np.stack([r.prompt for r in lane[:b]])).to(dev)
            dec, full = moe_golden(torch, keep_all, params, prompts, s + 16)
            line = {"phase": "lm moe", "check": "decode vs prefill", "arch": cfg.name, "s": s,
                    "rows": b, "compute_dtype": "float32",
                    "capacity_factor": keep_all.cfg.moe.capacity_factor,
                    "rel_err": rel_err(dec, full), "tolerance": TOL_LM_F32_GOLDEN,
                    "finite": bool(torch.isfinite(dec).all() and torch.isfinite(full).all())}
            emit(line)
            if not (line["finite"] and line["rel_err"] <= TOL_LM_F32_GOLDEN):
                raise AssertionError(f"lm moe {cfg.name} float32 decode vs prefill: {line}")
            del dec, full
            torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    n_flash = launches["flash_attention_fwd"] + n_loss
    del engines, eng, tap, params, p0
    gc.collect()
    torch.cuda.empty_cache()
    moe_check(torch, card, full_cfg, check, peak, phase_t0)
    return n_flash


def moe_check(torch, card: str, full_cfg, check, peak: float, phase_t0: float) -> None:
    """The check copy (``check``: layers, dense layers, routed experts; every
    width full) at float32 and capacity factor E / k for the decode gate,
    card against CPU on the same weights (the CPU runs the plain twins)."""
    import gc

    import numpy as np

    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.build import build
    from repro_torch.models.param import tree_map
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    layers, dense, experts = check
    cfg2 = moe_cfg(full_cfg, layers, dense, experts).scaled(compute_dtype="float32")
    m2 = build(cfg2)
    p2 = moe_params(torch, m2, False, 1)
    line = {"phase": "lm moe", "check": "copy", "arch": cfg2.name, "layers": layers,
            "dense_layers": dense, "experts": cfg2.moe.n_experts, "top_k": cfg2.moe.top_k,
            "n_params": m2.n_params, "note": "every width full; "
            + ("routed experts cut to %d" % experts if experts else "depth cut only")}
    emit(line)
    rng = np.random.default_rng(0)
    if experts:  # deepseek's decode gate runs here (see MOE_CHECK_GOLDEN)
        keep_all = build(moe_cfg(cfg2, layers, dense,
                                 capacity_factor=cfg2.moe.n_experts / cfg2.moe.top_k))
        for s, b in MOE_CHECK_GOLDEN:
            prompts = torch.from_numpy(rng.integers(0, cfg2.vocab, (b, s)).astype(np.int32))
            dec, full = moe_golden(torch, keep_all, p2, prompts.to(dev), s + 16)
            line = {"phase": "lm moe", "check": "decode vs prefill", "arch": cfg2.name,
                    "copy": True, "s": s, "rows": b, "compute_dtype": "float32",
                    "capacity_factor": keep_all.cfg.moe.capacity_factor,
                    "rel_err": rel_err(dec, full), "tolerance": TOL_LM_F32_GOLDEN}
            emit(line)
            if not line["rel_err"] <= TOL_LM_F32_GOLDEN:
                raise AssertionError(f"lm moe {cfg2.name} float32 decode vs prefill: {line}")
            del dec, full
    c2 = tree_map(lambda t: t.cpu(), p2)
    prompts = rng.integers(0, cfg2.vocab, (LM_QUEUES[0][3], LM_QUEUES[0][2])).astype(np.int32)
    b, s = prompts.shape
    toks = torch.from_numpy(prompts).to(dev)
    with MoeTap(torch, inputs=True) as card_tap:
        logits, _, _ = T.lm_forward(p2, toks, cfg2)
    with MoeTap(torch, inputs=True) as cpu_tap:
        ref, _, _ = T.lm_forward(c2, toks.cpu(), cfg2)
    forward_err = rel_err(logits.cpu(), ref)
    # each moe layer's expert ids, card against CPU; where they differ, the
    # CPU's score margin between its k-th and (k+1)-th expert
    differ, margins = 0, []
    k = cfg2.moe.top_k
    for a, c in zip(card_tap.calls, cpu_tap.calls):
        _, ids, _ = moe._router(a["p"], a["x"], cfg2.moe)
        _, cids, _ = moe._router(c["p"], c["x"], cfg2.moe)
        bad = (ids.cpu() != cids).any(-1)
        if bool(bad.any()):
            logit = torch.matmul(c["x"].float(), c["p"]["router"].float())
            score = torch.sigmoid(logit) if cfg2.moe.router_norm == "sigmoid" else logit
            top = moe.top_k(score, k + 1)[0]
            differ += int(bad.sum())
            margins += (top[..., k - 1] - top[..., k])[bad].tolist()
    del card_tap, cpu_tap
    _, caches = m2.prefill_fn(p2, {"tokens": toks[:, :-1]},
                              m2.init_cache_fn(b, 128, torch.float32, dev))
    _, c_caches = m2.prefill_fn(c2, {"tokens": toks[:, :-1].cpu()},
                                m2.init_cache_fn(b, 128, torch.float32, "cpu"))
    dec, _ = m2.decode_fn(p2, toks[:, -1:], s - 1, caches)
    dec_ref, _ = m2.decode_fn(c2, toks[:, -1:].cpu(), s - 1, c_caches)
    decode_err = rel_err(dec.cpu(), dec_ref)
    card_out = ServeEngine(m2, p2, batch=b, max_len=128).serve_queue(
        [Request(prompt=q, max_new=LM_CHECK_NEW) for q in prompts])
    cpu_out = ServeEngine(m2, c2, batch=b, max_len=128).serve_queue(
        [Request(prompt=q, max_new=LM_CHECK_NEW) for q in prompts])
    parted = []
    for i, (x, y) in enumerate(zip(card_out, cpu_out)):
        t = next((j for j, (u, w) in enumerate(zip(x.out, y.out)) if u != w), None)
        if t is not None:  # the CPU's top-2 margin where the two part
            seq = torch.from_numpy(np.append(prompts[i], y.out[:t]).astype(np.int32))[None]
            last, _ = m2.prefill_fn(c2, {"tokens": seq},
                                    m2.init_cache_fn(1, 128, torch.float32, "cpu"))
            top = torch.topk(last[0], 2).values
            parted.append({"request": i, "step": t, "margin": float(top[0] - top[1]),
                           "tolerance": TOL_LM_CPU * float(last.abs().max())})
    line = {"phase": "lm moe", "check": "card vs cpu", "arch": cfg2.name, "layers": layers,
            "dense_layers": dense, "experts": cfg2.moe.n_experts, "compute_dtype": "float32",
            "forward_rel_err": forward_err, "decode_rel_err": decode_err,
            "tolerance": TOL_LM_CPU, "expert_ids_differ": differ, "id_margins": margins,
            "tokens_equal": [x.out == y.out for x, y in zip(card_out, cpu_out)],
            "parted": parted, "peak_gb": peak / 1e9,
            "phase_seconds": time.perf_counter() - phase_t0, "card": card}
    emit(line)
    if not (forward_err <= TOL_LM_CPU and decode_err <= TOL_LM_CPU
            and all(mg == 0.0 for mg in margins)
            and all(pt["margin"] <= pt["tolerance"] for pt in parted)):
        raise AssertionError(f"lm moe {cfg2.name} card vs cpu: {line}")
    del p2, c2, caches, c_caches, logits, dec
    gc.collect()
    torch.cuda.empty_cache()


def lm_spectral_phase(torch, k, card, rows) -> dict:
    """fourier_lm's forward at full width on the card: each block's mixing
    planned onto the FFT kernels; returns the kernels' launches of the
    gated run."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core import spectral
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models import transformer as T
    from repro_torch.models.build import build
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.param import param_bytes, tree_map
    from repro_torch.plan.api import resolve_call

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config(SPECTRAL_ARCH)
    model = build(cfg)
    b, s = SPECTRAL_BATCH
    d = cfg.d_model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = phase_t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": "lm spectral", "call": "init", "arch": cfg.name, "family": cfg.family,
          "n_params": model.n_params, "param_bytes": param_bytes(model.skeleton),
          "seconds": time.perf_counter() - t0, "layers": cfg.n_layers, "d_model": d,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, "fft_variant": cfg.fft_variant,
          "compute_dtype": cfg.compute_dtype, "card": card})
    batch = make_batch(cfg, b, s, 0, device=dev)

    per_mix = mixing_census(s, d)
    expect = {name: cfg.n_layers * n for name, n in per_mix.items()}
    plan = resolve_call("fft2d", (b, s, d), dev, dtype="complex64").variant
    with torch.no_grad():
        # loss_fn and prefill_fn, each with the counts set to 0 just before
        # and read just after: the census's kernels once a block, no other.
        seen = {}
        for name, fn in (("loss_fn", lambda: model.loss_fn(params, batch)[0]),
                         ("prefill_fn", lambda: model.prefill_fn(params, batch, None)[0])):
            torch.cuda.synchronize()
            reset_launches()
            out = fn()
            torch.cuda.synchronize()
            seen[name] = {n: c for n, c in LAUNCHES.items() if c}
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"lm spectral: {name} is not finite")
            if name == "loss_fn":
                loss = float(out)
            else:
                last_shape = list(out.shape)
        emit({"phase": "lm spectral", "call": "launches", "arch": cfg.name, "batch": [b, s],
              "plan": plan, "per_mixing": per_mix, "expected": expect, **seen,
              "loss": loss, "prefill_logits": last_shape})
        if any(got != expect for got in seen.values()) or last_shape != [b, cfg.vocab]:
            raise AssertionError(f"lm spectral: launched {seen}, the census gives {expect}")
        launches = dict(seen["prefill_fn"])
        for name, n in seen["loss_fn"].items():
            launches[name] += n

        # The forward again with every fused-wrapper call recorded: each
        # launch held against its plain twin on the same inputs (2e-5) and
        # timed alone; the forward's time, tokens/s and the kernels' share.
        tap = KernelTap()
        try:
            calls = TappedCalls(torch, k, tap, rows, "lm spectral")
            _, line = calls("spectral_forward",
                            lambda: T.spectral_forward(params, batch["tokens"], cfg)[0],
                            (b, s, d), {"fft2d": plan}, list(expect),
                            forbid=[n for n in ("fft2_fused", "flash_attention_fwd")
                                    if n not in expect], reps=3, batches=3)
        finally:
            tap.restore()
        dt = getattr(torch, cfg.compute_dtype)
        h = rmsnorm(tree_map(lambda w: w[0], params["layers"])["ln1"],
                    embed(params["embed"], batch["tokens"], dt), cfg.rms_eps)
        mixing_ms = time_ms(lambda: spectral.fourier_mixing(h, variant=cfg.fft_variant))
        loss_ms = time_ms(lambda: model.loss_fn(params, batch)[0], reps=3, batches=3)
        line.update({"arch": cfg.name, "layers": cfg.n_layers, "tokens": b * s,
                     "tokens_per_s": b * s / (line["ms"] / 1e3), "loss_ms": loss_ms,
                     "mixing_ms": mixing_ms,
                     "mixing_share": cfg.n_layers * mixing_ms / line["ms"],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
        emit(line)
        for kn in line["kernels"]:
            rows[kn["kernel"]].setdefault("by_case", {})[
                f"{cfg.name} mixing {tuple(kn['shape'])}"] = {
                    "shape": kn["shape"], "ms": kn["ms"], "rel_err": kn["rel_err"],
                    "launches": expect[kn["kernel"]]}
        del h

        # The card against the CPU at float32 compute, full depth, the same
        # weights, on the first SPECTRAL_CHECK_BATCH sequences (the CPU plans
        # its plain schedules).
        cfg32 = cfg.scaled(compute_dtype="float32")
        model32 = build(cfg32)
        sub = {key: v[:SPECTRAL_CHECK_BATCH] for key, v in batch.items()}
        cpu_params = tree_map(lambda w: w.cpu(), params)
        logits, _, _ = T.spectral_forward(params, sub["tokens"], cfg32)
        ref, _, _ = T.spectral_forward(cpu_params, sub["tokens"].cpu(), cfg32)
        bf16, _, _ = T.spectral_forward(params, sub["tokens"], cfg)
        card_loss = float(model32.loss_fn(params, sub)[0])
        cpu_loss = float(model32.loss_fn(cpu_params, {key: v.cpu() for key, v in sub.items()})[0])
        line = {"phase": "lm spectral", "check": "card vs cpu", "arch": cfg.name,
                "layers": cfg.n_layers, "batch": [SPECTRAL_CHECK_BATCH, s],
                "compute_dtype": "float32", "logits_rel_err": rel_err(logits.cpu(), ref),
                "max_abs_logit": float(ref.abs().max()),
                "loss": card_loss, "cpu_loss": cpu_loss,
                "loss_rel_err": abs(card_loss - cpu_loss) / abs(cpu_loss),
                "tolerance": TOL_LM_CPU, "bf16_vs_cpu_float32_rel_err": rel_err(bf16.cpu(), ref),
                "phase_seconds": time.perf_counter() - phase_t0, "card": card}
        emit(line)
        if not (line["logits_rel_err"] <= TOL_LM_CPU and line["loss_rel_err"] <= TOL_LM_CPU):
            raise AssertionError(f"lm spectral card vs cpu: {line}")
    del params, cpu_params, batch, logits, ref, bf16
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The training phase (lm train): flash_attention_bwd, the card's only
# backward kernel, against its plain version (2e-5 on Gaussian operands)
# and float64 autograd of mha_reference (the model's own layer-0
# operands at llama3.2-3b's training lane; within LM_FLOAT64_FACTOR of the
# plain version's distance), timed beside its plain version, SDPA's
# backward and its bound: (name, B·H, Sq, Sk, D, Dv, causal, window).
TRAIN_BWD_CASES = (
    ("window", 32, 1024, 1024, 128, 128, True, 256),
    ("cross", 64, 128, 1500, 64, 64, False, None),
    ("mla 192->128", 32, 512, 512, 192, 128, True, None),
    ("dv 160", 32, 512, 512, 160, 160, True, None),
)
# Full-width training through repro_torch.launch.train's entry: (arch,
# batch, seq, steps). llama3.2-3b remats every layer (cfg.remat, "full"), so
# a step launches flash_attention_fwd twice a layer (forward, recompute)
# and flash_attention_bwd once; fourier_lm's mixing plans its FFT kernels
# in the forward, the recompute and the backward (Re(FFT2) of the
# cotangent); xlstm-350m (the reference's train_4k sequence, the batch cut
# to one card) launches slstm_scan twice an sLSTM layer and slstm_scan_bwd
# once.
TRAIN_RUNS = (("llama3.2-3b", 2, 1024, 3), ("fourier_lm", 8, 2048, 3),
              ("xlstm-350m", 4, 4096, 3))
# Card against CPU gradients at float32 compute (the same weights): the
# first TRAIN_CHECK_LAYERS layers of llama3.2-3b's full-width initial
# weights (a 28-layer init: its fan_in, the stacked layer count, gives them
# the full model's scale) on 2 sequences of TRAIN_CHECK_SEQ tokens, and
# fourier_lm at full depth on 2 of 2048, and xlstm-350m's first (mLSTM,
# sLSTM) pair on 2 of TRAIN_XLSTM_SEQ. Then the llama copy overfits one
# batch as the reference's test_adamw_reduces_loss does (12 steps at peak
# lr 1e-2, warmup 2: the last loss under 0.9 of the first).
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_SEQ = 256
TRAIN_XLSTM_SEQ = 64
# The card's gradients and the CPU's float32 ones are each held against
# the same model run on the CPU in float64 (float64_mode). At llama's init
# the softmax is nearly one-hot (scores of ~1e2), so dS = P (dP - delta)
# is a difference of nearly equal numbers and float32 amplifies a rounding
# in any order of summation: the card passes a leaf within TOL_LM_CPU of
# float64, or within LM_FLOAT64_FACTOR of the CPU's own distance, and never
# past this ceiling.
TRAIN_GRAD_CEILING = 5e-3
TRAIN_PEAK_GB = 85.0
TRAIN_OVERFIT_STEPS = 12


def mixing_census(s: int, d: int) -> dict:
    """The FFT kernels one planned fft2 of (B, s, d) frames launches at
    radix 4, by the census: one block a frame, else the composed route's
    row kernel and column pass (two row launches where H > 4096)."""
    from repro_torch.kernels import fft_radix2 as k
    from repro_torch.kernels import ops

    if ops.fft2_fits_budget(s, d):
        return {"fft2_fused": 1}
    if k.fft2_columns_serves(s):
        return {"fft_fused": 1, COLUMNS: 1}
    return {"fft_fused": 2}


# flash_attention_bwd's kernels by their template arguments (width
# instance, resident keys, what they accumulate): a dQ and a dK/dV pass at
# each width, the dK/dV pass as a dV and a dK kernel at 256.
FLASH_BWD_PASSES = {(32, 0, 1): "dq 32", (32, 1, 3): "dkdv 32", (64, 0, 1): "dq 64",
                    (64, 1, 3): "dkdv 64", (128, 0, 1): "dq 128", (128, 1, 3): "dkdv 128",
                    (256, 0, 1): "dq 256", (256, 1, 2): "dv 256", (256, 1, 1): "dk 256"}


def flash_bwd_ptxas() -> dict:
    """ptxas's registers and spill bytes of each of flash_attention_bwd's
    kernels, by pass and width instance."""
    from repro_torch.kernels import _build

    found = ptxas_entries(_build.build_log(), "16flash_bwd_kernel")
    return {FLASH_BWD_PASSES[k]: v for k, v in sorted(found.items()) if k in FLASH_BWD_PASSES}


def sdpa_mask(torch, sq: int, sk: int, causal: bool, window, q_offset: int, device):
    """The boolean mask of (query row r at q_offset + r, key c) pairs kept."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    keep = (kpos <= qpos) if causal else torch.ones(sq, sk, dtype=torch.bool, device=device)
    return keep & (kpos > qpos - window) if window is not None else keep


def sdpa_bwd_ms(torch, q, k, v, do, causal: bool, window=None, q_offset: int = 0):
    """CUDA-event ms of the backward of ``scaled_dot_product_attention`` at
    scale 1 on (BH, S, D) operands (a window or a query offset as a
    boolean mask): the gradients of q, k, v from a retained graph, or None
    where no backend takes the shapes."""
    import torch.nn.functional as F

    kw = {"is_causal": causal}
    if window is not None or q_offset:
        kw = {"attn_mask": sdpa_mask(torch, q.shape[1], k.shape[1], causal, window, q_offset,
                                     q.device)}
    qq, kk, vv = (x.detach()[None].requires_grad_() for x in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(qq, kk, vv, scale=1.0, **kw)
        return time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do[None],
                                                   retain_graph=True), reps=5, batches=3)
    except RuntimeError:
        return None


def float64_attention_grads(fa, q, k, v, do, causal: bool, window=None, q_scale: float = 1.0,
                            q_offset: int = 0):
    """Float64 autograd of ``mha_reference`` on (q·q_scale, k, v) with the
    cotangent ``do``: (dq, dk, dv) at q's own scale."""
    import torch

    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    out = fa.mha_reference(q * q_scale, k, v, causal=causal, window=window, q_offset=q_offset)
    return torch.autograd.grad(out, (q, k, v), do.double())


def flash_bwd_case(torch, card, case: str, q, k, v, do, opts, model=None, phase="lm train"):
    """flash_attention_bwd on (q, k, v, dO) at scale 1 with the forward's
    logsumexp: against its plain version (2e-5 of its largest gradient)
    and float64 autograd of ``mha_reference``; ``model`` is the model's
    own (q, k, v) at the same shape, held to float64 within
    LM_FLOAT64_FACTOR of the plain version's distance. Timed beside its
    plain version, SDPA's backward and its bound. Prints one line and
    returns it."""
    from repro_torch.kernels import flash_attention as fa

    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    q_scale = math.sqrt(d)  # the operands are pre-scaled; mha_reference scales by 1/sqrt(D)

    def errors(q, k, v, do):
        o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **opts)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, **opts)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **opts)
        exact = float64_attention_grads(fa, q, k, v, do, opts["causal"], opts["window"], q_scale,
                                        opts.get("q_offset", 0))
        return {"rel_err": max(rel_err(a, b) for a, b in zip(got, plain)),
                "max_abs_err": max(max_abs(a, b) for a, b in zip(got, plain)),
                "rel_err_vs_float64": max(rel_err(a, b) for a, b in zip(got, exact)),
                "plain_rel_err_vs_float64": max(rel_err(a, b) for a, b in zip(plain, exact))}

    off = opts.get("q_offset", 0)
    line = {"phase": phase, "kernel": "flash_attention_bwd", "case": case,
            "shape": [bh, sq, d], "keys": sk, "value_dim": dv, "causal": opts["causal"],
            "window": opts["window"], "q_offset": off, **errors(q, k, v, do)}
    if model is not None:
        mq, mk, mv = model
        line["model_operands"] = errors(mq, mk, mv, do)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    # each input read once, each gradient written once; per kept pair the
    # scores again (2 D), dP and dV (2 Dv each), dQ and dK (2 D each)
    cost = fa.bwd_cost(bh, sq, sk, d, dv, causal=opts["causal"], window=opts["window"],
                       q_offset=off)
    line.update({
        "ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, **opts), reps=5,
                      batches=3),
        "plain_ms": time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **opts),
                            reps=2, batches=3),
        "library_ms": sdpa_bwd_ms(torch, q, k, v, do, opts["causal"], opts["window"], off),
        "forward_ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, return_lse=True, **opts),
                              reps=5, batches=3),
        "forward_no_lse_ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, **opts), reps=5,
                                     batches=3),
        **cost._asdict(), "card": card})
    # The same float32-accurate products as the forward's, so the same
    # yardstick: the card's rate for them on the tensor cores (three TF32
    # products each), with the CUDA-core float32 figure beside it.
    line["bound_ms"], line["bound_by"] = bound(card, cost, split_tf32_rate(card))
    line["simt_bound_ms"] = bound(card, cost)[0]
    emit(line)
    worst = [line] + ([line["model_operands"]] if model is not None else [])
    if not line["rel_err"] <= TOL_KERNEL or not all(
            x["rel_err_vs_float64"] <= max(TOL_KERNEL, LM_FLOAT64_FACTOR
                                           * x["plain_rel_err_vs_float64"]) for x in worst):
        raise AssertionError(f"flash_attention_bwd at {case}: {line}")
    return line


def leaf_names(tree, prefix: str = "") -> list:
    """Dotted key paths of a dict tree's leaves, in tree order."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree) for n in leaf_names(tree[key], f"{prefix}{key}.")]
    return [prefix[:-1]]


def float64_mode(torch):
    """A ``TorchFunctionMode`` that runs the port's float32 model in float64
    (the oracle of lm train's gradient check): every float32, bfloat16 or
    complex64 dtype handed to a torch function, and ``Tensor.float``, is
    widened to float64 or complex128; ``narrow`` counts the tensors that
    still come out narrower. Autograd's backward formulas follow the
    forward's dtypes; a Python ``backward`` runs outside the mode (the
    Re(FFT2) mixing's casts its cotangent to complex64, so for fourier_lm
    the oracle is float32's in that one step)."""
    from torch.overrides import TorchFunctionMode

    wider = {torch.float32: torch.float64, torch.bfloat16: torch.float64,
             torch.float16: torch.float64, torch.complex64: torch.complex128}
    widen = lambda a: wider.get(a, a) if isinstance(a, torch.dtype) else a  # noqa: E731

    class Float64(TorchFunctionMode):
        narrow = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.float:
                func = torch.Tensor.double
            out = func(*map(widen, args), **{k: widen(v) for k, v in (kwargs or {}).items()})
            if isinstance(out, torch.Tensor) and out.dtype in wider:
                self.narrow += 1
            return out

    return Float64()


def grads_vs_cpu(torch, model, params, batch) -> dict:
    """``loss_fn``'s loss and gradients on the card (launches counted from
    0) and on the CPU at float32, on copies of the same weights and batch,
    each leaf held against the same model in float64 on the CPU
    (:func:`float64_mode`, default dtype float64, without remat, which
    changes no value): its gap relative to
    the largest float64 value. A leaf passes where the card's gap is at
    most TRAIN_GRAD_CEILING and at most TOL_LM_CPU or LM_FLOAT64_FACTOR
    times the CPU's. The card's gap from the CPU's float32 gradients is
    printed beside (``grad_rel_err``)."""
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models.build import build
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.train.loop import value_and_grad

    torch.cuda.synchronize()
    reset_launches()
    loss, _, grads = value_and_grad(model.loss_fn, params, batch)
    torch.cuda.synchronize()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    grads = [g.cpu() for g in tree_leaves(grads)]
    cpu = tree_map(lambda t: t.cpu(), params)
    cpu_batch = {key: v.cpu() for key, v in batch.items()}
    cpu_loss, _, ref = value_and_grad(model.loss_fn, cpu, cpu_batch)
    ref = tree_leaves(ref)
    wide = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    cpu, cpu_batch = tree_map(wide, cpu), tree_map(wide, cpu_batch)
    mode, default = float64_mode(torch), torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:  # without remat: its recompute runs in the backward, outside the mode
        with mode:
            exact_loss, _, exact = value_and_grad(build(model.cfg.scaled(remat=False)).loss_fn,
                                                  cpu, cpu_batch)
    finally:
        torch.set_default_dtype(default)
    exact = tree_leaves(exact)
    names = leaf_names(params)
    vs_cpu = {n: rel_err(a, b) for n, a, b in zip(names, grads, ref)}
    card = {n: rel_err(a, b) for n, a, b in zip(names, grads, exact)}
    own = {n: rel_err(a, b) for n, a, b in zip(names, ref, exact)}
    limit = {n: min(TRAIN_GRAD_CEILING, max(TOL_LM_CPU, LM_FLOAT64_FACTOR * own[n]))
             for n in names}
    return {"loss": float(loss), "cpu_loss": float(cpu_loss), "float64_loss": float(exact_loss),
            "loss_rel_err": abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss)),
            "grad_rel_err": max(vs_cpu.values()),
            "grad_rel_err_vs_float64": max(card.values()),
            "cpu_grad_rel_err_vs_float64": max(own.values()),
            "by_leaf": {n: {"vs_cpu": vs_cpu[n], "vs_float64": card[n],
                            "cpu_vs_float64": own[n], "limit": limit[n]} for n in names},
            "float64_narrow": mode.narrow,
            "passes": mode.narrow == 0 and all(card[n] <= limit[n] for n in names),
            "finite": all(bool(torch.isfinite(g).all()) for g in grads), "launches": launches}


def train_census(cfg, seq: int) -> dict:
    """Kernel launches of one training step of ``cfg`` on sequences of
    ``seq`` tokens under remat: the forward and the recompute each launch
    the forward kernels, the backward its own (fourier_lm: the mixing's
    planned FFT kernels in all three)."""
    if cfg.family == "spectral":
        return {n: 3 * cfg.n_layers * c for n, c in mixing_census(seq, cfg.d_model).items()}
    if cfg.family == "ssm":  # xlstm: an sLSTM layer every slstm_every
        pairs = cfg.n_layers // cfg.slstm_every
        return {"slstm_scan": 2 * pairs, "slstm_scan_bwd": pairs}
    return {"flash_attention_fwd": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}


def lm_train_phase(torch, card, rows) -> dict:
    """Training on the card: flash_attention_bwd's checks and times, the
    three full-width runs through ``repro_torch.launch.train`` (their
    launches are returned), card against CPU gradients and an overfit."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention as attn
    from repro_torch.models.build import build
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.param import tree_map
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainState, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)

    # The kernel at llama3.2-3b's training lane (B·H 48, S 1024, D 128,
    # causal, the config's blocks), Gaussian and the model's own layer-0
    # operands, and at the other families' shapes.
    cfg = get_config("llama3.2-3b")
    lane_b, lane_s = TRAIN_RUNS[0][1], TRAIN_RUNS[0][2]
    copy = cfg.scaled(n_layers=1)
    params = build(copy).init(torch.Generator(device=dev).manual_seed(0))
    dt = getattr(torch, cfg.compute_dtype)
    toks = make_batch(cfg, lane_b, lane_s, 0, device=dev)["tokens"]
    p0 = tree_map(lambda t: t[0], params["dense_layers"])
    h = rmsnorm(p0["ln1"], embed(params["embed"], toks, dt), cfg.rms_eps)
    positions = torch.arange(lane_s, device=dev)[None].expand(lane_b, lane_s)
    mq, mk, mv = attn.gqa_qkv(p0["attn"], h, cfg, positions)
    hd = cfg.resolved_head_dim
    model_ops = attn.gqa_to_heads(mq * (1.0 / math.sqrt(hd)), mk, mv)
    del params, h, mq, mk, mv
    bh = lane_b * cfg.n_heads
    q = torch.randn(bh, lane_s, hd, generator=gen, device=dev) / math.sqrt(hd)
    kk = torch.randn(bh, lane_s, hd, generator=gen, device=dev)
    v = torch.randn(bh, lane_s, hd, generator=gen, device=dev)
    do = torch.randn(bh, lane_s, hd, generator=gen, device=dev)
    opts = {"causal": True, "window": None, "block_q": cfg.attn_block_q,
            "block_k": cfg.attn_block_k, "scale": 1.0}
    main = flash_bwd_case(torch, card, f"{cfg.name} train lane", q, kk, v, do, opts,
                          model=model_ops)
    del q, kk, v, do, model_ops
    by_case = {"llama3.2-3b train lane": main}
    for name, bh, sq, sk, d, dv, causal, window in TRAIN_BWD_CASES:
        q = torch.randn(bh, sq, d, generator=gen, device=dev) / math.sqrt(d)
        kk = torch.randn(bh, sk, d, generator=gen, device=dev)
        v = torch.randn(bh, sk, dv, generator=gen, device=dev)
        do = torch.randn(bh, sq, dv, generator=gen, device=dev)
        by_case[name] = flash_bwd_case(torch, card, name, q, kk, v, do,
                                       {"causal": causal, "window": window, "block_q": 512,
                                        "block_k": 1024, "scale": 1.0})
    del q, kk, v, do
    keep = ("shape", "keys", "value_dim", "causal", "window", "rel_err", "rel_err_vs_float64",
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "simt_bound_ms",
            "forward_ms", "forward_no_lse_ms")
    ptxas = flash_bwd_ptxas()
    rows["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda", "source": KERNELS["flash_attention_bwd"][0],
        "replaces": KERNELS["flash_attention_bwd"][1], "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in by_case.values()),
        "rel_err": max(c["rel_err"] for c in by_case.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "simt_bound_ms": main["simt_bound_ms"],
        "library_ms": main["library_ms"],
        "shape": main["shape"], "by_case": {n: {x: c[x] for x in keep} for n, c in by_case.items()},
        "ptxas": ptxas}
    spilled = {n: e for n, e in ptxas.items()
               if int(n.split()[-1]) <= 128 and e.get("spill_stores", 1) + e.get("spill_loads", 1)}
    if len(ptxas) != len(FLASH_BWD_PASSES) or spilled:
        raise AssertionError(f"flash_attention_bwd's passes: ptxas {ptxas}; spilled {spilled}")

    # The two full-width runs through the launcher's entry, without
    # checkpoints (llama's state is 51 GB), the counts set to 0 just before
    # and read just after.
    fft_one = {}
    launches = {}
    for arch, b, s, steps in TRAIN_RUNS:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        reset_launches()
        out = launch_train.main(["--arch", arch, "--steps", str(steps), "--batch", str(b),
                                 "--seq", str(s), "--ckpt", "", "--device", "cuda"])
        torch.cuda.synchronize()
        seen = {n: c for n, c in LAUNCHES.items() if c}
        peak = torch.cuda.max_memory_allocated() / 1e9
        loop, losses = out["loop"], out["losses"]
        step_s = [loop.seconds[i] for i in sorted(loop.seconds)]
        step_ms = statistics.median(step_s[1:]) * 1e3
        layers = cfg.n_layers
        per_step = train_census(cfg, s)
        if cfg.family == "spectral":
            z = torch.randn(b, s, cfg.d_model, generator=gen, device=dev).to(torch.complex64)
            fft_one = {"ms": time_ms(lambda: ops.fft2_kernel(z, radix=4), reps=5, batches=3)}
            kernel_ms = 3 * layers * fft_one["ms"]
            del z
        elif "slstm_scan" in per_step:
            case = slstm_bwd_case(torch, card, b)
            scan_one = {k: case[k] for k in ("ms", "plain_ms", "forward_saving_ms",
                                             "barrier_floor_ms", "bound_ms", "rel_err",
                                             "saving_rel_err", "max_abs_err")}
            kernel_ms = (per_step["slstm_scan"] * scan_one["forward_saving_ms"]
                         + per_step["slstm_scan_bwd"] * scan_one["ms"])
            bwd_ms = per_step["slstm_scan_bwd"] * scan_one["ms"]
        else:
            kernel_ms = 2 * layers * main["forward_ms"] + layers * main["ms"]
            bwd_ms = layers * main["ms"]
        expect = {n: steps * c for n, c in per_step.items()}
        line = {"phase": "lm train", "call": "train", "arch": arch, "layers": layers,
                "d_model": cfg.d_model, "vocab": cfg.vocab, "n_params": out["model"].n_params,
                "remat": cfg.remat, "remat_policy": cfg.remat_policy,
                "compute_dtype": cfg.compute_dtype, "batch": [b, s], "steps": steps,
                "launches": seen, "expected": expect, "losses": [losses[i] for i in sorted(losses)],
                "step_ms": step_ms, "first_step_ms": step_s[0] * 1e3,
                "step_ms_all": [x * 1e3 for x in step_s], "tokens_per_s": b * s / (step_ms / 1e3),
                "kernel_ms_estimate": kernel_ms, "kernel_share_estimate": kernel_ms / step_ms,
                **({} if cfg.family == "spectral" else {
                    "bwd_ms_estimate": bwd_ms, "bwd_share_estimate": bwd_ms / step_ms}),
                "peak_gb": peak, "held_before_gb": held_gb,
                "card_gb": torch.cuda.get_device_properties(0).total_memory / 1e9, "card": card}
        if "slstm_scan" in per_step:
            line["slstm_scan_bwd_one"] = scan_one
        emit(line)
        del out, loop
        if (seen != expect or not all(np.isfinite(line["losses"]))
                or not peak <= TRAIN_PEAK_GB):
            raise AssertionError(f"lm train {arch}: launched {seen}, expected {expect}; "
                                 f"losses {line['losses']}; peak {peak} GB")
        for n, c in seen.items():
            launches[n] = launches.get(n, 0) + c
        if "slstm_scan_bwd" in per_step:
            rows["slstm_scan_bwd"].setdefault("by_case", {})[f"{arch} train {[b, s, 4 * cfg.d_model]}"] = {
                "launches_a_step": per_step["slstm_scan_bwd"], "step_ms": step_ms, **scan_one}
    if fft_one:
        for name in ("fft_fused", COLUMNS):
            rows[name].setdefault("by_case", {})["fourier_lm train (8, 2048, 512)"] = {
                "launches": launches.get(name, 0), "fft2_kernel_ms": fft_one["ms"]}
    gc.collect()
    torch.cuda.empty_cache()

    # Card against CPU gradients at float32, then the overfit.
    for arch, cut, seq in (("llama3.2-3b", {"n_layers": TRAIN_CHECK_LAYERS}, TRAIN_CHECK_SEQ),
                           ("fourier_lm", {}, 2048),
                           ("xlstm-350m", {"n_layers": 2}, TRAIN_XLSTM_SEQ)):
        params = build(get_config(arch)).init(torch.Generator(device=dev).manual_seed(0))
        cfg = get_config(arch).scaled(compute_dtype="float32", **cut)
        if cut:  # the full init's first layers (xlstm: its first pair)
            for name, n in (("dense_layers", cfg.n_layers), ("mlstm_layers", cfg.n_layers // 2),
                            ("slstm_layers", cfg.n_layers // 2)):
                if name in params:
                    params[name] = tree_map(lambda t: t[:n].clone(), params[name])
            torch.cuda.empty_cache()
        model = build(cfg)
        batch = make_batch(cfg, 2, seq, 1, device=dev)
        t0 = time.perf_counter()
        line = {"phase": "lm train", "check": "card vs cpu", "arch": arch, "layers": cfg.n_layers,
                "batch": [2, seq], "compute_dtype": "float32",
                **grads_vs_cpu(torch, model, params, batch), "tolerance": TOL_LM_CPU,
                "factor": LM_FLOAT64_FACTOR, "ceiling": TRAIN_GRAD_CEILING,
                "seconds": time.perf_counter() - t0, "card": card}
        emit(line)
        if not (line["finite"] and line["passes"] and line["loss_rel_err"] <= TOL_LM_CPU):
            raise AssertionError(f"lm train card vs cpu: {line}")
        expect = train_census(cfg, seq)
        if line["launches"] != expect:
            raise AssertionError(f"lm train card vs cpu: launched {line['launches']}, "
                                 f"expected {expect}")
        if arch == "llama3.2-3b":
            state = TrainState(params, adamw_init(params))
            step = make_train_step(model.loss_fn, peak_lr=1e-2, warmup=2, total=100)
            losses = []
            for _ in range(TRAIN_OVERFIT_STEPS):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            emit({"phase": "lm train", "check": "overfit", "arch": arch, "layers": cfg.n_layers,
                  "batch": [2, seq], "losses": losses, "ratio": losses[-1] / losses[0],
                  "card": card})
            if not losses[-1] < 0.9 * losses[0]:
                raise AssertionError(f"lm train overfit: {losses}")
            del state
        del model, params, batch
        gc.collect()
        torch.cuda.empty_cache()

    emit({"phase": "lm train", "check": "phase", "seconds": time.perf_counter() - phase_t0,
          "launches": launches, "card": card})
    return launches


# --------------------------------- lm dist ---------------------------------
#
# The sharding slice on the card: both flash kernels at a query offset (a
# context-parallel rank's slice of the queries), context-parallel prefill
# and expert-parallel MoE on gloo ranks sharing the card, and
# launch.train --distributed (world 1 on NCCL, 2 gloo ranks) against one
# process.
#
# flash_attention_fwd at an offset: (label, B·H, Sq, Sk, window, q_offset):
# llama3.2-3b's two CP ranks of an 8192-token prefill (24 heads of 128),
# mixtral-8x22b's second rank past its 4096 window (96 = 2 x 48 heads).
DIST_FWD_CASES = (
    ("llama3.2-3b cp rank 0", 24, 4096, 8192, None, 0),
    ("llama3.2-3b cp rank 1", 24, 4096, 8192, None, 4096),
    ("mixtral-8x22b window cp rank 1", 96, 4096, 8192, 4096, 4096),
)
# flash_attention_bwd at llama's training lane halved: the second rank of
# 1024 tokens, (label, B·H, Sq, Sk, q_offset).
DIST_BWD_CASE = ("llama3.2-3b train lane cp rank 1", 48, 512, 1024, 512)
# Context-parallel prefill: llama3.2-3b at full width cut to LM_CHECK_LAYERS
# layers (as the lm phase's check copy), float32 compute, one sequence of
# DIST_CP_SEQ tokens over DIST_WORLD ranks of a (1, DIST_WORLD) ("data",
# "model") mesh, cp over "model".
DIST_WORLD = 2
DIST_CP_SEQ = 8192
DIST_CP_SEED = 1
# Expert-parallel MoE: one mixtral-8x22b moe layer at full width (8 experts
# of d 6144 -> 16384, bf16, drawn an expert at a time from seed
# DIST_EP_SEED + e), float32 tokens (DIST_EP_TOKENS), capacity factor 8 so
# nothing drops, ep_axes ("data",) over DIST_WORLD ranks.
DIST_EP_TOKENS = (2, 256)
DIST_EP_SEED = 1000
DIST_EP_CF = 8.0
TOL_EP = 1e-4       # output, token and router gradients (float32)
TOL_EP_BF16 = 1e-2  # the bf16 experts' gradients (each rounded to bf16 once)
# launch.train --distributed: fourier_lm at full width, the lm train
# phase's batch, against one process on the whole batch.
DIST_TRAIN_ARGS = ("--arch", "fourier_lm", "--steps", "3", "--batch", "8", "--seq", "2048",
                   "--ckpt", "")
TOL_DIST_LOSS = 1e-5
DIST_DEADLINE_S = 300.0


def flash_fwd_ptxas() -> dict:
    """ptxas's registers and spill bytes of each flash_attention_fwd
    instance (its output accumulator's n-tiles)."""
    from repro_torch.kernels import _build

    return {f"nv {k[0]}": v for k, v in
            sorted(ptxas_entries(_build.build_log(), "22flash_attention_kernel").items())}


def dist_kernel_lines(torch, card: str, rows) -> None:
    """Both flash kernels at a query offset, at full width, against their
    plain versions on the card; timed beside SDPA with the same mask and
    the bound; both kernels' ptxas gated on 0 spills."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    d = LLAMA["head_dim"]
    for label, bh, sq, sk, window, off in DIST_FWD_CASES:
        q, kk, v = (torch.randn(bh, n, d, generator=gen, device=dev) for n in (sq, sk, sk))
        opts = dict(causal=True, window=window, q_offset=off)
        got = fa.flash_attention_fwd(q, kk, v, **opts)
        ref = fa.flash_attention_plain(q, kk, v, **opts)
        torch.cuda.synchronize()
        mask = sdpa_mask(torch, sq, sk, True, window, off, dev)
        cost = fa.fwd_cost(bh, sq, sk, d, d, causal=True, window=window, q_offset=off)
        line = {"phase": "lm dist", "kernel": "flash_attention_fwd", "case": label,
                "shape": [bh, sq, d], "keys": sk, "window": window, "q_offset": off,
                "rel_err": rel_err(got, ref), "max_abs_err": max_abs(got, ref),
                "ms": time_ms(lambda: fa.flash_attention_fwd(q, kk, v, **opts), reps=5,
                              batches=3),
                "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, kk, v, **opts), reps=2,
                                    batches=3),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q[None], kk[None], v[None], attn_mask=mask), reps=5, batches=3),
                **cost._asdict(), "card": card}
        line["bound_ms"], line["bound_by"] = bound(card, cost, split_tf32_rate(card))
        emit(line)
        if not line["rel_err"] <= TOL_KERNEL:
            raise AssertionError(f"flash_attention_fwd {label}: rel err {line['rel_err']}")
        rows["flash_attention_fwd"].setdefault("by_case", {})[label] = {
            x: line[x] for x in ("shape", "keys", "window", "q_offset", "rel_err", "ms",
                                 "plain_ms", "library_ms", "bound_ms", "bound_by")}
        del q, kk, v, got, ref, mask
        torch.cuda.empty_cache()
    label, bh, sq, sk, off = DIST_BWD_CASE
    q = torch.randn(bh, sq, d, generator=gen, device=dev) / math.sqrt(d)
    kk, v = (torch.randn(bh, sk, d, generator=gen, device=dev) for _ in range(2))
    do = torch.randn(bh, sq, d, generator=gen, device=dev)
    line = flash_bwd_case(torch, card, label, q, kk, v, do,
                          {"causal": True, "window": None, "block_q": 512, "block_k": 1024,
                           "scale": 1.0, "q_offset": off}, phase="lm dist")
    rows["flash_attention_bwd"].setdefault("by_case", {})[label] = {
        x: line[x] for x in ("shape", "keys", "q_offset", "rel_err", "rel_err_vs_float64", "ms",
                             "plain_ms", "library_ms", "bound_ms", "bound_by")}
    # Gated: the forward instances the models run (Dv 64, 128 and 160 / 256:
    # 8, 16 and 32 n-tiles; the Dv <= 32 instance, nv 4, spilled before the
    # query offset came and runs on no main path) and the backward's widths
    # up to 128, as the lm train phase gates them.
    fwd, bwd = flash_fwd_ptxas(), flash_bwd_ptxas()
    gated = {**{n: e for n, e in fwd.items() if int(n.split()[-1]) >= 8},
             **{n: e for n, e in bwd.items() if int(n.split()[-1]) <= 128}}
    spilled = {n: e for n, e in gated.items() if e.get("spill_stores", 1) + e.get("spill_loads", 1)}
    emit({"phase": "lm dist", "check": "ptxas", "flash_attention_fwd": fwd,
          "flash_attention_bwd": bwd, "spilled": spilled, "card": card})
    if not fwd or spilled:
        raise AssertionError(f"flash kernels spill: {spilled}")


def dist_cp_model(torch, dev):
    """The CP prefill's model, its weights and its tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.build import build

    cfg = get_config(LM_ARCH).scaled(n_layers=LM_CHECK_LAYERS, compute_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(DIST_CP_SEED))
    gen = torch.Generator(device=dev).manual_seed(DIST_CP_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (1, DIST_CP_SEQ), generator=gen, device=dev)
    return cfg, model, params, toks.to(torch.int32)


def dist_ep_cfg():
    """mixtral-8x22b's config, its moe layer on ``ep_a2a`` over ("data",)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("mixtral-8x22b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="ep_a2a", ep_axes=("data",), capacity_factor=DIST_EP_CF))


def dist_ep_inputs(torch, dev, experts):
    """The EP layer's config, its router and tokens (float32, every rank the
    same) and the bf16 experts numbered ``experts`` (wg, wu, wd stacked),
    each drawn from its own seed, so a rank draws only its own."""
    cfg = dist_ep_cfg()
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    gen = torch.Generator(device=dev).manual_seed(DIST_EP_SEED - 1)
    router = torch.randn(d, e, generator=gen, device=dev) / math.sqrt(d)
    x = torch.randn(*DIST_EP_TOKENS, d, generator=gen, device=dev)
    w = {n: torch.empty(len(experts), *shape, dtype=torch.bfloat16, device=dev)
         for n, shape in (("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d)))}
    for i, ex in enumerate(experts):
        g = torch.Generator(device=dev).manual_seed(DIST_EP_SEED + ex)
        for n in ("wg", "wu", "wd"):
            fan_in = w[n].shape[1]
            w[n][i] = torch.randn(*w[n].shape[1:], generator=g, device=dev) / math.sqrt(fan_in)
    return cfg, router, x, w


def dist_ep_grads(torch, moe, cfg, p, x):
    """y and the gradients of sum(y²) for x, the router and the experts."""
    y, _ = moe.moe_apply(p, x, cfg)
    leaves = [x, p["router"], p["wg"], p["wu"], p["wd"]]
    return y, dict(zip(("x", "router", "wg", "wu", "wd"),
                       torch.autograd.grad((y ** 2).sum(), leaves)))


def dist_rank(kind: str, rank: int, world: int, tmp: str) -> int:
    """``--dist-rank KIND RANK WORLD DIR``: one rank of the lm dist phase on
    the card. ``cp`` and ``ep`` join a gloo group (a ``FileStore`` in DIR);
    ``train`` runs ``launch.train --distributed`` on gloo, its group from
    the environment its parent set. Writes its result to DIR."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.kernels._launch import LAUNCHES, reset_launches

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"rank": rank, "world": world}
    if kind == "train":
        from repro_torch.launch import train as launch_train

        reset_launches()
        res = launch_train.main(["--distributed", "--dist-backend", "gloo", "--device", "cuda",
                                 *DIST_TRAIN_ARGS])
        torch.cuda.synchronize()
        out.update(losses=[res["losses"][i] for i in sorted(res["losses"])],
                   launches={n: c for n, c in LAUNCHES.items() if c},
                   step_ms=[res["loop"].seconds[i] * 1e3 for i in sorted(res["loop"].seconds)],
                   writes=res["loop"].ckpt is not None)
    else:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"store_{kind}"),
                                                             world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        try:
            out.update((dist_cp_rank if kind == "cp" else dist_ep_rank)(torch, dev, rank, world,
                                                                         tmp))
        finally:
            dist.destroy_process_group()
    with open(os.path.join(tmp, f"{kind}{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def dist_cp_rank(torch, dev, rank: int, world: int, tmp: str) -> dict:
    """The CP prefill on this rank: its launches, the offsets its attention
    ran at, its collectives; rank 0 saves the logits and layer 0's
    gathered attention output."""
    import os

    from repro_torch import compat
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models import attention as attn
    from repro_torch.sharding.ctx import activation_sharding

    cfg, model, params, toks = dist_cp_model(torch, dev)
    mesh = compat.make_mesh((1, world), ("data", "model"))
    offsets, layer0, inner, inner_cp = [], [], attn.flash_attention, attn.flash_attention_cp

    def spy(*a, **kw):
        offsets.append(kw.get("q_offset", 0))
        return inner(*a, **kw)

    def cp_spy(*a, **kw):
        y = inner_cp(*a, **kw)
        if not layer0:
            layer0.append(y)
        return y

    attn.flash_attention, attn.flash_attention_cp = spy, cp_spy
    try:
        with torch.no_grad(), compat.set_mesh(mesh), activation_sharding(
                dp=("data",), dp_sizes=(1,), tp=None, tp_size=1, cp="model", cp_size=world):
            model.prefill_fn(params, {"tokens": toks}, None)  # warm
            torch.cuda.synchronize()
            offsets.clear()
            layer0.clear()
            torch.cuda.reset_peak_memory_stats()
            compat.reset_collectives()
            reset_launches()
            t0 = time.perf_counter()
            logits, _ = model.prefill_fn(params, {"tokens": toks}, None)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {n: c for n, c in LAUNCHES.items() if c}
            collectives = dict(compat.COLLECTIVES)
    finally:
        attn.flash_attention, attn.flash_attention_cp = inner, inner_cp
    if rank == 0:
        torch.save({"logits": logits.cpu(), "layer0": layer0[0].cpu()},
                   os.path.join(tmp, "cp_out.pt"))
    return {"launches": launches, "offsets": offsets, "collectives": collectives,
            "host_ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "layers": cfg.n_layers}


def dist_ep_rank(torch, dev, rank: int, world: int, tmp: str) -> dict:
    """The EP layer on this rank: its experts as DTensor shards, y and the
    gradients; rank 0 saves y and the token and router gradients, every
    rank its experts' gradients' first 256 x 256 block and norms."""
    import os

    from torch.distributed.tensor import DTensor

    from repro_torch import compat
    from repro_torch.compat import P, to_placements
    from repro_torch.models import moe

    torch.cuda.reset_peak_memory_stats()
    mesh = compat.make_mesh((world,), ("data",))
    e_loc = dist_ep_cfg().moe.n_experts // world
    mine = range(rank * e_loc, (rank + 1) * e_loc)
    cfg, router, x, w = dist_ep_inputs(torch, dev, mine)
    placed = to_placements(P("data", None, None), mesh)
    p = {"router": router.requires_grad_(),
         **{n: DTensor.from_local(t, mesh, placed).requires_grad_() for n, t in w.items()}}
    x.requires_grad_()
    held_gb = torch.cuda.memory_allocated() / 1e9
    with compat.set_mesh(mesh):
        compat.reset_collectives()
        y, aux = moe.moe_apply(p, x, cfg)
        forward = dict(compat.COLLECTIVES)
        grads = torch.autograd.grad((y ** 2).sum(), [x, p["router"], p["wg"], p["wu"], p["wd"]])
        torch.cuda.synchronize()
    total = dict(compat.COLLECTIVES)
    experts = {}
    for n, g in zip(("wg", "wu", "wd"), grads[2:]):
        g = g.to_local()
        experts[n] = {"block": g[:, :256, :256].float().cpu(),
                      "norms": g.float().norm(dim=(1, 2)).cpu()}
    torch.save(experts, os.path.join(tmp, f"ep_experts{rank}.pt"))
    if rank == 0:
        torch.save({"y": y.detach().cpu(), "x": grads[0].cpu(), "router": grads[1].cpu(),
                    "aux": aux.detach().cpu()}, os.path.join(tmp, "ep_out.pt"))
    return {"experts": list(mine), "local_shape": list(p["wg"].to_local().shape),
            "expert_gb": sum(t.to_local().numel() * 2 for n, t in p.items() if n != "router")
            / 1e9, "held_gb": held_gb, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "forward_collectives": forward, "collectives": total}


def dist_group(kind: str, tmp: str, world: int, env=None):
    """Start ``world`` ``--dist-rank`` processes of ``kind`` (their logs in
    ``tmp``)."""
    import os

    procs = []
    for r in range(world):
        extra = {} if env is None else env(r)
        with open(os.path.join(tmp, f"{kind}{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--dist-rank", kind, str(r),
                 str(world), tmp], stdout=log, stderr=subprocess.STDOUT,
                env={**os.environ, **extra}))
    return procs


def dist_join(groups: dict, tmp: str) -> dict:
    """Wait for every rank of ``groups`` ({kind: procs}) within the phase's
    deadline; a failing or late rank fails the phase. Returns each kind's
    ranks' results."""
    import os

    deadline = time.monotonic() + DIST_DEADLINE_S
    every = [(k, r, p) for k, procs in groups.items() for r, p in enumerate(procs)]
    for kind, r, proc in every:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            for _, _, q in every:
                q.kill()
                q.wait()
            with open(os.path.join(tmp, f"{kind}{r}.log")) as f:
                raise AssertionError(f"lm dist {kind}: rank {r} exit {rc}: {f.read()[-3000:]}")
    out = {}
    for kind, procs in groups.items():
        out[kind] = []
        for r in range(len(procs)):
            with open(os.path.join(tmp, f"{kind}{r}.json")) as f:
                out[kind].append(json.load(f))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def lm_dist_phase(torch, card: str, rows) -> dict:
    """The lm dist lines; returns the launches of the phase's main-path runs
    (the CP ranks' prefills, the distributed training runs)."""
    import dataclasses
    import gc
    import os
    import tempfile

    import numpy as np

    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention as attn
    from repro_torch.models import moe

    gc.collect()
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    dev = torch.device("cuda")
    dist_kernel_lines(torch, card, rows)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Each group's one-process reference runs while its ranks do.
        groups = {"cp": dist_group("cp", tmp, DIST_WORLD)}
        cfg, model, params, toks = dist_cp_model(torch, dev)
        first, inner = [], attn.flash_attention

        def spy(*a, **kw):
            y = inner(*a, **kw)
            if not first:
                first.append(y)
            return y

        attn.flash_attention = spy
        try:
            with torch.no_grad():
                single, _ = model.prefill_fn(params, {"tokens": toks}, None)
        finally:
            attn.flash_attention = inner
        single, single_layer0 = single.cpu(), first[0].cpu()
        del model, params, first
        gc.collect()
        torch.cuda.empty_cache()
        ranks = dist_join(groups, tmp)
        groups = {"ep": dist_group("ep", tmp, DIST_WORLD)}
        ep_cfg, router, x, w = dist_ep_inputs(torch, dev, range(dist_ep_cfg().moe.n_experts))
        g_cfg = dataclasses.replace(ep_cfg, moe=dataclasses.replace(ep_cfg.moe,
                                                                   impl="grouped_local"))
        p = {"router": router.requires_grad_(), **{n: t.requires_grad_() for n, t in w.items()}}
        x.requires_grad_()
        y_g, g_g = dist_ep_grads(torch, moe, g_cfg, p, x)
        torch.cuda.synchronize()
        ranks.update(dist_join(groups, tmp))

        # context-parallel prefill
        cp_out = torch.load(os.path.join(tmp, "cp_out.pt"))
        per_rank = DIST_CP_SEQ // DIST_WORLD
        line = {"phase": "lm dist", "call": "cp prefill", "arch": LM_ARCH, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "heads": cfg.n_heads, "compute_dtype": cfg.compute_dtype,
                "tokens": list(toks.shape), "mesh": [1, DIST_WORLD], "backend": "gloo",
                "logits_rel_err_vs_one_rank": rel_err(cp_out["logits"], single),
                "layer0_attention_rel_err": rel_err(cp_out["layer0"], single_layer0),
                "ranks": ranks["cp"], "tolerance": TOL_LM_CPU, "card": card,
                "note": "gloo stages the gather through host memory: not the NCCL number"}
        emit(line)
        for r, res in enumerate(ranks["cp"]):
            if (res["launches"] != {"flash_attention_fwd": cfg.n_layers}
                    or res["offsets"] != [r * per_rank] * cfg.n_layers
                    or res["collectives"]["all_gather"] != cfg.n_layers):
                raise AssertionError(f"lm dist cp prefill: rank {r}: {res}")
            launches["flash_attention_fwd"] = (launches.get("flash_attention_fwd", 0)
                                               + res["launches"]["flash_attention_fwd"])
        if not (line["logits_rel_err_vs_one_rank"] <= TOL_LM_CPU
                and line["layer0_attention_rel_err"] <= TOL_LM_CPU
                and bool(torch.isfinite(cp_out["logits"]).all())):
            raise AssertionError(f"lm dist cp prefill: {line}")
        rows["flash_attention_fwd"].setdefault("by_case", {})["llama3.2-3b cp prefill ranks"] = {
            "launches": launches["flash_attention_fwd"], "q_offsets": [r["offsets"][0]
                                                                       for r in ranks["cp"]]}

        # expert-parallel moe layer
        ep = torch.load(os.path.join(tmp, "ep_out.pt"))
        errs = {"y": rel_err(ep["y"], y_g.detach().cpu()), "x": rel_err(ep["x"], g_g["x"].cpu()),
                "router": rel_err(ep["router"], g_g["router"].cpu())}
        for r, res in enumerate(ranks["ep"]):
            mine = torch.load(os.path.join(tmp, f"ep_experts{r}.pt"))
            for n in ("wg", "wu", "wd"):
                whole = g_g[n][res["experts"][0]:res["experts"][-1] + 1]
                errs[f"{n} rank {r}"] = max(
                    rel_err(mine[n]["block"], whole[:, :256, :256].float().cpu()),
                    rel_err(mine[n]["norms"], whole.float().norm(dim=(1, 2)).cpu()))
        line = {"phase": "lm dist", "call": "ep moe layer", "arch": "mixtral-8x22b",
                "d_model": ep_cfg.d_model, "experts": ep_cfg.moe.n_experts,
                "d_ff_expert": ep_cfg.moe.d_ff_expert, "expert_dtype": "bfloat16",
                "tokens": list(DIST_EP_TOKENS), "capacity_factor": DIST_EP_CF,
                "ep_axes": ["data"], "backend": "gloo", "rel_err_vs_grouped_local": errs,
                "ranks": ranks["ep"], "one_process_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "tolerance": TOL_EP, "bf16_tolerance": TOL_EP_BF16, "card": card}
        emit(line)
        n_exp = ep_cfg.moe.n_experts
        expert_gb = 3 * n_exp * ep_cfg.d_model * ep_cfg.moe.d_ff_expert * 2 / 1e9
        for r, res in enumerate(ranks["ep"]):
            if (res["local_shape"][0] != n_exp // DIST_WORLD
                    or abs(res["expert_gb"] - expert_gb / DIST_WORLD) > 1e-6
                    or res["forward_collectives"]["all_to_all"] != 3):
                raise AssertionError(f"lm dist ep: rank {r}: {res}")
        bad = {k: e for k, e in errs.items()
               if not e <= (TOL_EP if k in ("y", "x", "router") else TOL_EP_BF16)}
        if bad:
            raise AssertionError(f"lm dist ep: {bad}")
        del p, x, w, router, y_g, g_g, ep
        gc.collect()
        torch.cuda.empty_cache()

        # launch.train --distributed: 2 gloo ranks, world 1 on NCCL, one process
        port = free_port()
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(DIST_WORLD)}
        groups = {"train": dist_group("train", tmp, DIST_WORLD,
                                      lambda r: {**env, "RANK": str(r), "LOCAL_RANK": str(r)})}
        args = [*DIST_TRAIN_ARGS, "--device", "cuda"]
        one = launch_train.main(args)["losses"]
        saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                                 "MASTER_ADDR", "MASTER_PORT")}
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(free_port()))
        try:
            reset_launches()
            nccl = launch_train.main(["--distributed", *args])
            torch.cuda.synchronize()
            nccl_launches = {n: c for n, c in LAUNCHES.items() if c}
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        ranks.update(dist_join(groups, tmp))
    one = [one[i] for i in sorted(one)]
    nccl_losses = [nccl["losses"][i] for i in sorted(nccl["losses"])]
    step_ms = [nccl["loop"].seconds[i] * 1e3 for i in sorted(nccl["loop"].seconds)]

    def worst(losses):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, one))

    from repro_torch.configs import get_config

    t_cfg = get_config(DIST_TRAIN_ARGS[1])
    census = {n: int(DIST_TRAIN_ARGS[3]) * c
              for n, c in train_census(t_cfg, int(DIST_TRAIN_ARGS[7])).items()}
    line = {"phase": "lm dist", "call": "train --distributed", "arch": t_cfg.name,
            "batch": [int(DIST_TRAIN_ARGS[5]), int(DIST_TRAIN_ARGS[7])], "one_process": one,
            "nccl_world_1": {"losses": nccl_losses, "rel_err": worst(nccl_losses),
                             "step_ms": step_ms, "launches": nccl_launches},
            "gloo_world_2": [{"rel_err": worst(r["losses"]), **r} for r in ranks["train"]],
            "census": census, "tolerance": TOL_DIST_LOSS, "card": card}
    emit(line)
    if not (line["nccl_world_1"]["rel_err"] <= TOL_DIST_LOSS and nccl_launches == census
            and all(r["rel_err"] <= TOL_DIST_LOSS and r["launches"] == census
                    and r["writes"] is False for r in line["gloo_world_2"])
            and all(np.isfinite(one))):
        raise AssertionError(f"lm dist train: {line}")
    for res in [{"launches": nccl_launches}, *ranks["train"]]:
        for n, c in res["launches"].items():
            launches[n] = launches.get(n, 0) + c
    emit({"phase": "lm dist", "check": "phase", "seconds": time.perf_counter() - phase_t0,
          "launches": launches, "card": card})
    return launches


# --------------------------------- dryrun ---------------------------------

# The dry-run's cell held against the card: llama3.2-3b's training lane
# (arch, global batch, sequence) on a one-card mesh.
DRYRUN_CELL = ("llama3.2-3b", 2, 1024)
# The card's peak over the dry-run's prediction (argument + temp bytes):
# the caching allocator rounds each block up to 512 bytes and holds the
# cuBLAS workspace, which the count does not see (PERF.md, PR 38).
DRYRUN_PEAK_BAND = (0.99, 1.03)


def dryrun_phase(torch, card: str) -> dict:
    """The dryrun line: the dry-run of DRYRUN_CELL on meta tensors against
    the same step on the card (module docstring, 7i); returns the card
    step's launches."""
    import gc

    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    from repro_torch.models.param import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainState

    gc.collect()
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    arch, b, s = DRYRUN_CELL
    res = dryrun.run_cell(arch, "train_4k", mesh="card_1x1", seq=s, batch=b)
    meta_s = time.perf_counter() - phase_t0
    cell = dryrun.build_cell(arch, "train_4k", "card_1x1", seq=s, batch=b)
    meta, _ = dryrun.count_step(cell)
    dev = torch.device("cuda")
    params = cell.model.init(torch.Generator(device=dev).manual_seed(0))
    state = TrainState(params, adamw_init(params))
    batch = {k: v.to(torch.int32) for k, v in make_batch(cell.cfg, b, s, 0, device=dev).items()}
    live = sum(t.numel() * t.element_size() for t in tree_leaves((state.tree(), batch)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    card_count, _ = dryrun.count_step(cell, (state, batch))
    torch.cuda.synchronize()
    counted_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: c for n, c in LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    step_ms = time_ms(lambda: cell.step(state, batch), reps=1, batches=3)
    predicted = res["memory"]["argument_bytes"] + res["memory"]["temp_bytes"]
    diff = {op: (row["flops"], card_count.ops.get(op, {}).get("flops"))
            for op, row in meta.ops.items()
            if row["flops"] != card_count.ops.get(op, {}).get("flops")}
    line = {"phase": "dryrun", "arch": arch, "batch": b, "seq": s, "mesh": "card_1x1",
            "argument_bytes": res["memory"]["argument_bytes"], "live_state_bytes": live,
            "flops_meta": meta.flops, "flops_card": card_count.flops,
            "flops_run_cell": res["cost"]["flops"], "flops_by_op_differing": diff,
            "bytes_meta": meta.bytes, "bytes_card": card_count.bytes,
            "kernels_meta": meta.kernels, "kernels_card": card_count.kernels,
            "temp_bytes": res["memory"]["temp_bytes"], "temp_bytes_card_count":
            card_count.peak_bytes, "predicted_peak_gb": predicted / 1e9,
            "peak_gb": peak / 1e9, "peak_ratio": peak / predicted, "band": DRYRUN_PEAK_BAND,
            "roofline": res["roofline"], "roofline_step_ms": res["roofline"]["roofline_step_s"]
            * 1e3, "step_ms": step_ms, "counted_step_ms": counted_ms, "launches": launches,
            "meta_seconds": meta_s, "seconds": time.perf_counter() - phase_t0, "card": card}
    emit(line)
    census = train_census(cell.cfg, s)
    del state, params, batch, cell, card_count, meta
    gc.collect()
    torch.cuda.empty_cache()
    if not (live == line["argument_bytes"] and line["flops_meta"] == line["flops_card"]
            == line["flops_run_cell"] and not diff and launches == census
            and DRYRUN_PEAK_BAND[0] <= line["peak_ratio"] <= DRYRUN_PEAK_BAND[1]):
        raise AssertionError(f"dryrun: {line}")
    return launches


def no_degrade(trace, phase: str, ops) -> None:
    """The standing check of the main path: no ``resilience.failover``,
    ``resilience.fault`` or ``plan.degrade`` event, no MEASURE candidate
    skipped, and the composed 2D route (``kernel.failover``) only on frames
    over the census. Prints one line for ``phase`` and clears ``trace``."""
    bad = [e for e in trace if e.name in DEGRADE_EVENTS]
    skipped = [e for e in trace.select("plan.measure") if e.get("skipped")]
    composed = {}
    for e in trace.select("kernel.failover"):
        h, w = e["shape"]
        fits = ops.fft2_fits_budget(h, w, real=e["kind"] != "fft2d")
        name = f"{e['kind']} {h}x{w}" + (" (fits the census)" if fits else "")
        composed[name] = composed.get(name, 0) + 1
    line = {"phase": "resilience", "check": "no degrade", "of": phase, "events": len(trace),
            "engine_apply": len(trace.select("engine.apply")),
            "degrade_events": len(bad), "skipped_candidates": len(skipped),
            "kernel_failover": composed}
    emit(line)
    if bad or skipped or any(n.endswith("(fits the census)") for n in composed):
        raise AssertionError(f"{phase}: a degrade on the main path: "
                             f"{[(e.name, e.fields) for e in (bad + skipped)[:5]]} {composed}")
    trace.events.clear()


class Clock:
    """The breaker's injected clock: ``clock.now += 31.0`` ends a cooldown."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def host_us(fn, iters: int = 200) -> float:
    """Host wall time a call of ``fn``, each call waited for."""
    import torch

    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def rotated_us(cases, reps: int = 21, iters: int = 200):
    """Median :func:`host_us` of each of ``cases`` ({name: fn}) over
    ``reps`` rounds that rotate their order, as ``_obs_cost`` does."""
    names = list(cases)
    for fn in cases.values():
        fn()
    samples = {n: [] for n in names}
    for rep in range(reps):
        for n in names[rep % len(names):] + names[:rep % len(names)]:
            samples[n].append(host_us(cases[n], iters))
    return {n: statistics.median(v) for n, v in samples.items()}


def resilience_phase(torch, k, xfft, card: str) -> None:
    """The degradation ladder, the census seam and MEASURE on the card, with
    injected faults; one line a check. Its launches are its own: they do
    not count toward the ``kernels`` line."""
    from repro_torch import resilience

    clock = Clock()
    resilience.reset()
    resilience.configure(cooldown_s=COOLDOWN_S, clock=clock)
    tap = KernelTap()
    try:
        _failover_checks(torch, k, xfft, tap, clock, card)
        _census_checks(torch, k, xfft, card)
        _measure_checks(torch, xfft, card)
        _ladder_cost(torch, xfft, card)
    finally:
        tap.restore()
        resilience.reset()
        resilience.configure(cooldown_s=COOLDOWN_S, clock=time.monotonic)
    torch.cuda.empty_cache()


def _tapped(torch, k, tap, fn):
    """Run ``fn`` once; returns its output, the launches it made and the
    radices of the fused-wrapper calls it made."""
    before, tap.recorded, tap.recording = dict(k.LAUNCHES), [], True
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        tap.recording = False
    launches = {n: k.LAUNCHES[n] - before[n] for n in k.LAUNCHES if k.LAUNCHES[n] != before[n]}
    radices = sorted({kw.get("radix", 2) for _, _, _, kw in tap.recorded})
    tap.recorded = []
    return out, launches, radices


def _failover_checks(torch, k, xfft, tap, clock, card: str) -> None:
    from repro_torch import obs, resilience
    from repro_torch.plan import default_cache, resolve_call
    from repro_torch.resilience import FaultPlan, FaultSpec, InjectedFault

    dev = torch.device("cuda")
    frames = torch.from_numpy(frame_source(0, *REG)).to(dev)
    fid = fid_source(torch, *TWO_PASS_COMPLEX, seed=4)
    cases = (
        ("fft2", "fft2d", frames.to(torch.complex64), "complex64", xfft.fft2, torch.fft.fft2,
         {"fft2_fused": 1}, {"fft2_fused": 1}),
        ("rfft2", "rfft2d", frames, "float32", xfft.rfft2, torch.fft.rfft2,
         {"rfft2_fused": 1}, {"rfft2_fused": 1}),
        ("fft", "fft1d", fid, "complex64", xfft.fft, torch.fft.fft,
         {"fft_two_pass": 2}, {"fft_cluster": 1}),
    )
    for name, kind, x, dtype, fn, library, on_fused, on_r4 in cases:
        resilience.reset()
        clock.now = 0.0
        want = library(x)
        planned = resolve_call(kind, tuple(x.shape), dev, dtype=dtype)
        fault = FaultPlan(FaultSpec("engine.apply", match={"engine": "fused_r4", "kind": kind},
                                    times=1))
        steps = []
        with obs.capture() as trace, xfft.config(faults=fault):
            for step, expect, radix in (("failover", on_fused, [2]),
                                        ("quarantined", on_fused, [2]),
                                        ("half-open probe", on_r4, [4])):
                if step == "half-open probe":
                    clock.now += COOLDOWN_S + 1.0
                out, launches, radices = _tapped(torch, k, tap, lambda: fn(x))
                steps.append({"step": step, "launches": launches, "radix": radices,
                              "rel_err": rel_err(out, want)})
                if launches != expect or radices != radix or not steps[-1]["rel_err"] <= \
                        TOL_REQUEST:
                    raise AssertionError(f"failover {name} {step}: {steps[-1]}, want "
                                         f"{expect} at radix {radix}")
                del out
        (failover,) = trace.select("resilience.failover")
        line = {"phase": "resilience", "check": "failover", "call": f"{name} {tuple(x.shape)}",
                "card": card, "planned": planned.variant, "steps": steps,
                "failover": {f: failover[f] for f in ("engine", "next", "reason", "quarantined")},
                "outcomes": [e["outcome"] for e in trace.select("plan.resolve")],
                "breaker": [e["state"] for e in trace.select("resilience.breaker")],
                "cached": default_cache().get(planned.key).variant}
        emit(line)
        if (planned.variant, line["failover"]["next"], line["outcomes"], line["breaker"],
                line["cached"]) != ("fused_r4", "fused", ["hit", "quarantined", "hit"],
                                    ["open", "half_open", "closed"], "fused_r4"):
            raise AssertionError(f"failover {name}: {line}")
    del fid

    # Every rung fails: the last injected error is raised, and no plain
    # schedule runs on the card.
    resilience.reset()
    x = frames.to(torch.complex64)
    plain = tap.plain_calls
    with obs.capture() as trace, xfft.config(faults=FaultPlan(FaultSpec("engine.apply"))):
        try:
            _tapped(torch, k, tap, lambda: xfft.fft2(x))
            raised = None
        except InjectedFault as e:
            raised = repr(e)
    line = {"phase": "resilience", "check": "all rungs fail", "call": f"fft2 {REG}",
            "raised": raised,
            "rungs": [(e["engine"], e["next"]) for e in trace.select("resilience.failover")],
            "engine_apply": len(trace.select("engine.apply")),
            "plain_schedule_calls": tap.plain_calls - plain}
    emit(line)
    if raised is None or line["rungs"] != [("fused_r4", "fused"), ("fused", None)] \
            or line["plain_schedule_calls"] or line["engine_apply"]:
        raise AssertionError(f"all rungs fail: {line}")

    # The health guard: a poisoned fused_r4 output fails over to fused;
    # then its cost a call, host time with the guard and without.
    resilience.reset()
    want = torch.fft.fft2(x)
    nan = FaultPlan(FaultSpec("engine.apply", mode="nan", match={"engine": "fused_r4"},
                              times=1))
    with obs.capture() as trace, xfft.config(faults=nan, check_health="nan"):
        out, launches, radices = _tapped(torch, k, tap, lambda: xfft.fft2(x))
    (failover,) = trace.select("resilience.failover")
    resilience.reset()

    def guarded():
        with xfft.config(check_health="nan"):
            return xfft.fft2(x)

    def scoped():
        with xfft.config(check_health="off"):
            return xfft.fft2(x)

    us = rotated_us({"guard on": guarded, "guard off": scoped}, reps=11)
    line = {"phase": "resilience", "check": "health guard", "call": f"fft2 {REG}", "card": card,
            "failover": {f: failover[f] for f in ("engine", "next", "reason")},
            "finite": bool(torch.isfinite(out).all()), "rel_err": rel_err(out, want),
            "radix": radices, "host_us_guard_on": us["guard on"],
            "host_us_guard_off": us["guard off"],
            "guard_us_per_call": us["guard on"] - us["guard off"],
            # the guard's check alone, back to back (CUDA events), and the
            # same check over the real view of the output
            "isfinite_all_ms": time_ms(lambda: torch.isfinite(out).all()),
            "isfinite_all_real_view_ms": time_ms(
                lambda: torch.isfinite(torch.view_as_real(out)).all())}
    emit(line)
    if not line["finite"] or line["failover"] != {"engine": "fused_r4", "next": "fused",
                                                  "reason": "nonfinite"} \
            or not line["rel_err"] <= TOL_REQUEST:
        raise AssertionError(f"health guard: {line}")
    resilience.reset()


def _census_checks(torch, k, xfft, card: str) -> None:
    """An injected ``vmem`` fault at ``kernel.fused`` on frames that fit one
    block: the composed route (the row kernel and fft2_columns, no corner
    turn), timed at its kernel entry against the one-block route."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.resilience import FaultPlan, FaultSpec

    dev = torch.device("cuda")
    frames = torch.from_numpy(frame_source(5, *REG)).to(dev)
    half = torch.fft.rfft2(frames)
    vmem = FaultPlan(FaultSpec("kernel.fused", mode="vmem"))
    for name, x, frame_kernel, composed in (
            ("fft2", frames.to(torch.complex64), "fft2_fused", {"fft_fused": 1, COLUMNS: 1}),
            ("rfft2", frames, "rfft2_fused", {"rfft_fused": 1, COLUMNS: 1}),
            ("irfft2", half, "irfft2_fused", {COLUMNS: 1, "irfft_fused": 1})):
        fn = getattr(xfft, name)
        want = getattr(torch.fft, name)(x)
        before = dict(k.LAUNCHES)
        with obs.capture() as trace, xfft.config(faults=vmem):
            got = fn(x)
            torch.cuda.synchronize()
        launches = {n: k.LAUNCHES[n] - before[n] for n in k.LAUNCHES
                    if k.LAUNCHES[n] != before[n]}
        (event,) = trace.select("kernel.failover")

        entry = getattr(ops, f"{name}_kernel")

        def composed_call():
            with xfft.config(faults=vmem):
                return entry(x, radix=4)

        line = {"phase": "resilience", "check": "census seam", "call": f"{name} {REG}",
                "card": card, "launches": launches, "rel_err": rel_err(got, want),
                "kernel_failover": {f: event[f] for f in ("kind", "shape", "frames",
                                                          "working_set", "budget")},
                "composed_ms": time_ms(composed_call),
                "one_block_ms": time_ms(lambda: entry(x, radix=4)),
                "front_door_ms": time_ms(lambda: fn(x))}
        line["composed_over_one_block"] = line["composed_ms"] / line["one_block_ms"]
        emit(line)
        if launches != composed or not line["rel_err"] <= TOL_REQUEST:
            raise AssertionError(f"census seam {name}: {line}, want {composed}")
        del got, want


# The second process of the wisdom check: loads the file into a fresh
# PlanCache and plans every key again under mode="measure".
WISDOM_PROCESS = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch import obs
from repro_torch.plan import PlanCache, plan_fft
cache = PlanCache(path=sys.argv[2])
with obs.capture() as trace:
    for kind, shape, dtype, direction, precision in json.loads(sys.argv[3]):
        plan_fft(kind, tuple(shape), torch.device("cuda"), dtype=dtype, mode="measure",
                 cache=cache, direction=direction, precision=precision)
print(json.dumps({"outcomes": [e["outcome"] for e in trace.select("plan.resolve")],
                  "measured": len(trace.select("plan.measure")), "entries": len(cache)}))
"""


def _measure_checks(torch, xfft, card: str) -> None:
    """MEASURE on the request keys, both directions: each candidate timed
    with CUDA events, beside ESTIMATE's pick; the wisdom file loads in a
    second process that times nothing; the double key times
    ``reference_x64`` alone; a graph capture degrades."""
    import os
    import tempfile

    from repro_torch import obs
    from repro_torch.plan import PlanCache, plan_fft, resolve_call
    from repro_torch.plan.autotune import estimate_plan, estimate_variant_time

    dev = torch.device("cuda")
    keys = [(kind, shape, dtype, direction, "single") for kind, shape, dtype in MEASURE_KEYS
            for direction in ("fwd", "inv")]
    keys.append((*MEASURE_X64_KEY, "fwd", "double"))
    agree = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xfft_plans.json")
        cache = PlanCache(path=path)
        for kind, shape, dtype, direction, precision in keys:
            timings = {}
            with obs.capture() as trace:
                plan = plan_fft(kind, shape, dev, dtype=dtype, mode="measure", cache=cache,
                                timings_out=timings, direction=direction,
                                precision=precision)
            (span,) = trace.select("plan.measure")
            est = estimate_plan(plan.key)
            line = {"phase": "resilience", "check": "measure", "kind": kind,
                    "shape": list(shape), "direction": direction, "precision": precision,
                    "card": card, "timings_us": timings, "measured": plan.variant,
                    "estimated": est.variant, "agree": plan.variant == est.variant,
                    "estimate_us": {v: estimate_variant_time(plan.key, v) * 1e6
                                    for v in timings}}
            if len(timings) > 1:
                ranked = sorted(timings.values())
                line["margin"] = (ranked[1] - ranked[0]) / ranked[0]
            emit(line)
            agree += line["agree"]
            want = {"reference_x64"} if precision == "double" else {"fused", "fused_r4"}
            if set(timings) != want or plan.mode != "measure" or span.get("skipped"):
                raise AssertionError(f"measure {kind} {shape} {direction}: {line}, "
                                     f"{span.fields}")
        out = subprocess.run([sys.executable, "-c", WISDOM_PROCESS, str(ROOT / "src"), path,
                              json.dumps(keys)], capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"wisdom process failed: {out.stderr[-2000:]}")
        second = json.loads(out.stdout.strip().splitlines()[-1])
    line = {"phase": "resilience", "check": "wisdom", "keys": len(keys),
            "measure_agrees_with_estimate": agree, "second_process": second}
    emit(line)
    if second != {"outcomes": ["hit"] * len(keys), "measured": 0, "entries": len(keys)}:
        raise AssertionError(f"wisdom: {line}")

    # MEASURE inside a CUDA graph capture degrades and times nothing.
    x = torch.ones(16, device=dev)
    graph = torch.cuda.CUDAGraph()
    with obs.capture() as trace:
        with torch.cuda.graph(graph):
            y = x * 2.0
            plan = resolve_call("fft2d", (64, 128, 128), dev, cache=PlanCache(),
                                mode="measure")
    graph.replay()
    torch.cuda.synchronize()
    line = {"phase": "resilience", "check": "graph capture", "plan_mode": plan.mode,
            "degrade_reason": plan.degrade_reason,
            "measured": len(trace.select("plan.measure")), "replayed": float(y.sum())}
    emit(line)
    if (plan.degrade_reason, line["measured"], line["replayed"]) != ("trace_not_clean", 0, 32.0):
        raise AssertionError(f"graph capture: {line}")

    # The output-health guard inside a graph capture: it reads nothing while
    # the stream captures, so the captured call runs its kernel rung and no
    # rung is charged a failure; the replay is held to torch.fft.
    frames = torch.from_numpy(frame_source(6, *REG)).to(dev).to(torch.complex64)
    with xfft.config(check_health="nan"):
        xfft.fft2(frames)  # plans, and opts the kernel into its shared memory
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with obs.capture() as trace:
            with torch.cuda.graph(graph):
                out = xfft.fft2(frames)
    graph.replay()
    torch.cuda.synchronize()
    line = {"phase": "resilience", "check": "health guard in graph capture",
            "call": f"fft2 {REG}", "check_health": "nan",
            "engines": [e["engine"] for e in trace.select("engine.apply")],
            "failovers": len(trace.select("resilience.failover")),
            "rel_err": rel_err(out, torch.fft.fft2(frames))}
    emit(line)
    if line["failovers"] or not line["rel_err"] <= TOL_REQUEST:
        raise AssertionError(f"health guard in graph capture: {line}")


def _ladder_cost(torch, xfft, card: str) -> None:
    """Host µs a call of the front door, of ``run_plan`` around the planned
    engine's op (with the always-on telemetry sinks, and without them:
    what the ``engine.apply`` span's sinks cost), and of the op alone;
    each call waited for, 21 reps in rotating order."""
    from repro_torch.engines import get_engine
    from repro_torch.obs import telemetry
    from repro_torch.plan import resolve_call
    from repro_torch.resilience import run_plan

    def without_sinks(fn):
        def call():
            saved = telemetry.flight_recorder(), telemetry.calibration_ledger()
            telemetry.set_flight_recorder(None)
            telemetry.set_calibration_ledger(None)
            try:
                return fn()
            finally:
                telemetry.set_flight_recorder(saved[0])
                telemetry.set_calibration_ledger(saved[1])
        return call

    dev = torch.device("cuda")
    for shape in ((256, 256), RECON):
        x = torch.randn(*shape, device=dev, dtype=torch.complex64)
        plan = resolve_call("fft2d", shape, dev)
        op = get_engine(plan.variant).op("fft2d", "fwd")
        us = rotated_us({"front door": lambda: xfft.fft2(x),
                         "run_plan": lambda: run_plan(plan, lambda v: op(x)),
                         "run_plan no sinks": without_sinks(
                             lambda: run_plan(plan, lambda v: op(x))),
                         "engine op": lambda: op(x),
                         "engine op no sinks": without_sinks(lambda: op(x))})
        emit({"phase": "resilience", "check": "ladder cost", "call": f"fft2 {shape}",
              "card": card, "engine": plan.variant,
              **{f"{n.replace(' ', '_')}_us": v for n, v in us.items()},
              "ladder_us": us["run_plan"] - us["engine op"],
              "ladder_no_sinks_us": us["run_plan no sinks"] - us["engine op no sinks"],
              "front_door_over_op_us": us["front door"] - us["engine op"]})
        del x


def slstm_time(root: str, backward: bool = False) -> int:
    """``--slstm-time ROOT [--backward]``: slstm_scan at xlstm-350m from
    ROOT's ``src``, its time and the sha256 of its outputs, as one JSON
    line; with ``--backward`` slstm_scan_bwd's instead, from the saving
    forward at the model's init scale (``"ms": null`` where ROOT has no
    backward kernel)."""
    import hashlib

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        return 2
    import importlib

    module = importlib.import_module("repro_torch.kernels.slstm_scan")

    def digest(*ts):
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()

    if backward:
        line = {"root": root, "card": card_info(), "hs_sha256": None, "final_sha256": None,
                "ms": None}
        if hasattr(module, "slstm_scan_bwd"):
            xg, w, state = slstm_inputs(torch, torch.device("cuda"), fan_in=XLSTM_TRAIN_FAN_IN)
            gen = torch.Generator(device=xg.device).manual_seed(15)
            b, l, d = XLSTM["batch"], XLSTM["seq"], XLSTM["d"]
            dhs = torch.randn(b, l, d, generator=gen, device=xg.device)
            dfinal = tuple(torch.randn(b, d, generator=gen, device=xg.device) for _ in range(4))
            _, _, saved = module.slstm_scan_saving(xg, w["wr"], w["bias"], *state)
            args = (saved, w["wr"], state[0], state[1], state[3], dhs, dfinal)
            dxg, grads = module.slstm_scan_bwd(*args)
            line.update({"hs_sha256": digest(dxg), "final_sha256": digest(*grads),
                         "ms": time_ms(lambda: module.slstm_scan_bwd(*args), reps=2,
                                       batches=3)})
        emit(line)
        return 0

    xg, w, state = slstm_inputs(torch, torch.device("cuda"))
    hs, final = module.slstm_scan(xg, w["wr"], w["bias"], *state)

    line = {"root": root, "card": card_info(), "hs_sha256": digest(hs),
            "final_sha256": digest(*final),
            "ms": time_ms(lambda: module.slstm_scan(xg, w["wr"], w["bias"], *state),
                          reps=2, batches=3)}
    if hasattr(module, "slstm_barriers"):  # the cooperative grid's barriers alone
        b, l, d = XLSTM["batch"], XLSTM["seq"], XLSTM["d"]
        line["barrier_floor_ms"] = time_ms(lambda: module.slstm_barriers(b, d, l),
                                           reps=2, batches=3)
    emit(line)
    return 0


def slstm_ab(other: str, backward: bool = False) -> int:
    """``--slstm-ab OTHER_ROOT [--backward]``: :func:`slstm_time` of
    OTHER_ROOT and of this checkout, one process each, in turns other,
    this, this, other."""
    runs = []
    for root in (other, str(ROOT), str(ROOT), other):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--slstm-time", root,
                              *(["--backward"] if backward else [])],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    emit({"slstm_ab": runs, "bit_for_bit": len({(r["hs_sha256"], r["final_sha256"])
                                                 for r in runs}) == 1})
    return 0


def main() -> int:
    if len(sys.argv) in (3, 4) and sys.argv[1] in ("--slstm-ab", "--slstm-time"):
        if len(sys.argv) == 4 and sys.argv[3] != "--backward":
            print(f"chip_smoke: unknown option {sys.argv[3]}", file=sys.stderr)
            return 2
        return (slstm_ab if sys.argv[1] == "--slstm-ab" else slstm_time)(
            sys.argv[2], len(sys.argv) == 4)
    if len(sys.argv) == 5 and sys.argv[1] == "--pencil-rank":
        return pencil_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if len(sys.argv) == 6 and sys.argv[1] == "--dist-rank":
        return dist_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch import obs, xfft
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fft_radix2 as k
    from repro_torch.plan.api import resolve_call

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit({"phase": "build", "seconds": build_s, "card": card, "ptxas": ptxas})
    print(card, flush=True)

    # One capture over the kernel, request, imaging, mri, stream, serve, pencil, lm, lm
    # state, lm audio, lm spectral, lm moe, lm train and lm dist phases:
    # each is held to no degrade on the main path (no_degrade clears it
    # after each).
    with obs.capture() as trace:
        rows = kernel_phase(torch, k, card)
        composed_phase(torch, k, card)
        rows["fft_two_pass"] = two_pass_phase(torch, k, card)
        rows["fft_cluster"] = cluster_phase(torch, k, card)
        model_rows, slstm_hs = model_kernel_phase(torch, card)
        rows.update(model_rows)
        no_degrade(trace, "kernel", ops)
        launches = request_phase(torch, k, xfft, resolve_call)
        no_degrade(trace, "request", ops)
        for name, n in imaging_phase(torch, k, xfft, resolve_call, rows).items():
            launches[name] += n
        no_degrade(trace, "imaging", ops)
        for name, n in mri_phase(torch, k, xfft, resolve_call, rows).items():
            launches[name] += n
        no_degrade(trace, "mri", ops)
        for name, n in stream_phase(torch, k, card).items():
            launches[name] += n
        no_degrade(trace, "stream", ops)
        for name, n in serve_phase(torch, k, card).items():
            launches[name] += n
        no_degrade(trace, "serve", ops)
        for name, n in pencil_phase(torch, k, card).items():
            launches[name] += n
        no_degrade(trace, "pencil", ops)
        lm_launches = lm_phase(torch, card, rows)
        no_degrade(trace, "lm", ops)
        state_launches = lm_state_phase(torch, card, rows)
        no_degrade(trace, "lm state", ops)
        state_launches["flash_attention_fwd"] += lm_audio_phase(torch, card, rows)
        no_degrade(trace, "lm audio", ops)
        for name, n in lm_spectral_phase(torch, k, card, rows).items():
            launches[name] += n
        no_degrade(trace, "lm spectral", ops)
        state_launches["flash_attention_fwd"] += lm_moe_phase(torch, card, rows)
        no_degrade(trace, "lm moe", ops)
        train_launches = lm_train_phase(torch, card, rows)
        no_degrade(trace, "lm train", ops)
        dist_launches = lm_dist_phase(torch, card, rows)
        no_degrade(trace, "lm dist", ops)
        for name, n in dryrun_phase(torch, card).items():
            dist_launches[name] = dist_launches.get(name, 0) + n
        no_degrade(trace, "dryrun", ops)
    serve_fault_phase(torch, k, card)
    resilience_phase(torch, k, xfft, card)
    launches.update({name: n for name, n in path_phase(torch, card, slstm_hs).items()
                     if name in model_rows})
    launches["flash_attention_fwd"] += lm_launches
    for name, n in (*state_launches.items(), *train_launches.items(), *dist_launches.items()):
        launches[name] += n
    for name, row in rows.items():
        row["launches"] = launches[name]
        if row["launches"] < 1:
            raise AssertionError(f"{name} was never launched on the main path")
    emit({"kernels": list(rows.values()), "card": card})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
