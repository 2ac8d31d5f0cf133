"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``ldpc_sims_tpu_torch`` only (it imports neither ``jax`` nor
``ldpc_sims_tpu``), in these phases:

1. build the CUDA decode and encode kernels from the checkout's sources,
   print ptxas's register/shared-memory report and the card's name and power
   limit, and fail unless each of the 36 sum-product kernels with a
   check's slots in registers (the _sr kernels), each of the 36
   group-serial kernels (the _gs kernels) and each of the 36 min-sum
   kernels on the compressed state's wide word (the _cw kernels) has a 0 B
   stack frame, printing their registers, and unless the 18 serial-C
   sum-product kernels on the wide rows (_rw), the 36 group-serial
   kernels there (_gw) and the 18 flooding sum-product kernels there
   (_lw) were built, printing their registers and stack frames (a _gw,
   _rw or _lw row of phase 4 whose kernel has a stack frame fails unless
   it runs faster than the full-message kernel it replaces); the build's
   ten translation units (nine of the decode, one of the encode) each
   print their compile time;
2. hold each kernel against its plain PyTorch version on the card at
   batch 4096: flooding-20 (α=1, β=0), flooding-20 (α=0.75, β=0.1,
   clamp 20), the registry's trained layered-8 on wifi1944 and wifi648
   flooding-20; posteriors within 1e-4 absolute + 1e-4 relative and hard
   bits equal wherever |posterior| > 1e-3. Then the early-stop forms, on
   wifi1944 and wifi648 at 1.5 and 3.0 dB, each exactly equal to the plain
   version: the fixed kernels' unsatisfied-check counts (also against an
   external bits·Hᵀ mod 2), the early-stop kernels at K = 1 and 2
   (bits and iterations), the ``done_in`` skip (flagged rows of a
   sentinel-filled output untouched), both drivers, and the probe driver
   forced into its overflow branch at 0 dB. Then (2c) every sum-product
   and message-quantized form (sum-product, min-sum with 4-bit messages,
   sum-product with 4-bit messages; both schedules) on wifi1944 and
   wifi648 at 1.5 dB with 64 rows saturated at |LLR| = 60: posteriors
   within the tolerance and finite, and bits, unsatisfied-check counts,
   early-stop bits and iterations, the ``done_in`` skip and both drivers
   exactly equal to the plain version. Then (2d) the eight weighted forms
   (both rules, both schedules, with and without 4-bit messages) with
   random per-edge weights in [0.7, 1.3] on wifi1944 and wifi648 at 1.5
   dB, and the committed K6 decoder (its ms arrays as the α/β table):
   posteriors within the tolerance, bits and counts equal; the
   group-serial layered schedule (the _gs kernels) at G = 2, 3, 4 and mb
   for min-sum and sum-product on channel LLRs with 64 rows saturated at
   |LLR| = 60 (posteriors and bits exactly equal) and with early stop at
   G = 3 (bits and iterations equal); G = 1 equal bit for bit to the
   serial-C kernel and plain version; G = mb within 1e-4 of flooding for
   all but at most one codeword in a thousand. Then (2e)
   every form at bf16 and int8 message storage on wifi1944 and wifi648 at
   1.5 dB with 64 rows saturated at |LLR| = 60 (both rules, both
   schedules, with and without 4-bit messages: posteriors, bits and
   counts, early stop, ``done_in``; the weighted forms, G = 2, 3, 4 and
   mb, and both drivers), every comparison exactly equal, then
   qc12288_r12 layered-10
   at all three storage types, batch 256. Then (2f) every min-sum
   layered form (fixed with its unsatisfied-check count, early stop at
   K = 1 and 2, ``done_in``, weighted; with and without 3-bit messages)
   and both drivers at f32, bf16 and int8 and G = 1, 2, 3, 4 and mb on
   1024 codewords of integer LLRs in {-3, ..., 3} (tied minima, zero
   magnitudes, an offset
   above the minimum: the inputs a compressed check state could get
   wrong) on wifi1944 and wifi648 (serial-C on the _cs kernels, G > 1 on
   the _gs kernels), at G = 1 on qc648_r23, qc648_r56, qc1944_r23 and
   qc1944_r56 (rows of degree 8-9 and 17-18: the wide word's _cw kernels),
   at G = 2, 3, 4 and mb on qc648_r23, qc648_r56, qc1944_r34 and
   qc1944_r56 (the wide word's _gw kernels) and at G = 4 on a code with a
   row of degree 10, which no wide body has (qc1944_r34's base with one
   circulant dropped: full messages), and every min-sum flooding
   form (the same forms, no drivers) at the three types on wifi1944,
   wifi648, qc8448_r12 (the compressed state) and the four high-rate codes
   (the wide word), each exactly equal, each decode failing unless it
   takes its design. Then (2g) every sum-product form (fixed with its
   unsatisfied-check count, early stop at K = 1 and 2, ``done_in``,
   weighted; with and without 4-bit messages; both schedules; 4
   iterations) and both drivers (2 + 4 iterations) at f32, bf16 and int8
   on wifi1944, wifi648 and qc8448_r12, which take the _sr kernels, on
   wifi1944 and wifi648 at G = 2, 3, 4 and mb, which take the _gs kernels,
   on qc648_r23, qc648_r56, qc1944_r34 and qc1944_r56 at G = 1 (serial-C
   on the _rw kernels, flooding on the _lw kernels) and 2, 4 and mb (the
   _gw kernels), flooding on qc648_r34 and qc1944_r23 (the _lw kernels:
   all six wide codes), and on the degree-10 code at G = 1 and 2, which
   keeps the full-message kernels, on 1024 codewords of channel LLRs with
   64 rows saturated at |LLR| = 60, each exactly equal;
3. the main paths at full width, each through ``run_sweep`` → ``mc_step``
   → ``link_step`` → ``bp_decode`` on wifi1944, QPSK, OFDM-32, batch
   32768, with the launch counters set to 0 just before and read just
   after each run: flooding-20 and trained layered-8 at 1.5 and 2.0 dB;
   layered-20 with ``early_stop`` and ``es_mode='auto'`` at 2.5 and 3.5
   dB (the mode chosen per point and both calibration times, a profile of
   one step in each mode); ``es_mode='probe'`` and ``'requeue'`` alone at
   3.5 dB; flooding-20 with ``es_mode='freeze'`` at 2.0 dB; flooding-20 on
   the channel of ``docs/artifacts/20260820_minsum_trained.json`` (BPSK,
   all-zero codewords, info bits counted, 8 × 32768 a point), its BER at
   1.5 and 2.0 dB held within 4σ of the artifact's. Checks the
   error rates (uncoded BER against the QPSK formula, coded below
   uncoded, BLER falling with SNR), prints BER/BLER and steady-state
   decoded info bits/s, and checks on one shared batch at 3.0 dB, where
   the stragglers fit the probe's capacity, that the probe decode's
   stragglers equal the fixed layered-20 decode bit for bit;
3b. the ``ofdm-qam16`` preset's own configuration (16-QAM over OFDM-64,
   layered-20, ``es_mode='auto'``) at 8 and 10 dB, 4 chunks per point;
3c. the ``wifi648-sweep`` preset (wifi648, layered-20 sum-product,
   ``es_mode='auto'``) at 2.0 and 3.0 dB, 4 chunks of 8 × 4096 per point,
   its 2.0 dB BLER held within 4σ of the JAX package's committed curve,
   its _sr entry point launched, and a profile of one preset step in each
   of es auto's two modes at 2.0 dB;
   the same configuration in flooding, flooding with ``es_mode='freeze'``
   and layered with ``es_mode='requeue'`` at 2.0 dB (the other three
   sum-product kernels on a main path); the ``quantized-minsum`` preset at
   2.0 dB for message widths 3, 4 and 5, each BLER held within 4σ of its
   committed curve; one wifi648 point behind a 3-bit ADC with the global
   AGC at 8 dB, coded BER below uncoded;
3d. the configuration ``sweep --code wifi1944 --schedule layered --iters 6
   --clamp 0 --weights-ckpt docs/artifacts/edge_layered_1944_K6.npz``
   builds, at 1.5 and 2.0 dB beside plain layered-6 on the same seeds (its
   coded BER below plain layered-6's at both), a profile of its step, and
   the K6 decoder on the artifact's own BPSK channel at 1.75 and 2.25 dB,
   8 × 32768 all-zero codewords each: BER within 4/√(frames in error)
   relative of the artifact's 2.604e-3 and 9.04e-5 and at 1.75 dB at
   least 5× below plain layered-6; flooding-12 with random per-edge
   weights at 1.5 dB; ``sweep --schedule layered --iters 20
   --layered-group 4`` beside layered-20 at 1.5 and 2.0 dB, with phase
   3's flooding-20 on the same seeds (the entry point it launched, its
   BER/BLER beside layered-20's, a profile of its step), and its
   sum-product form; the committed
   TPU sweeps' configuration of qc1944_r23, r34 and r56
   (``docs/artifacts/20260821_qc1944_r*_sweep_tpu.json``: layered-20
   min-sum, ``es_mode='freeze'``, clamp 20, the wide word's
   ``minsum_qc_layered_es_cw``), built by ``sweep_configs`` from the
   flags those sweeps ran with, their Eb/N0 grid ``--snr 1:4.5:8
   --snr-unit eb`` (each Es/N0 point within 1e-9 of the artifact's, the
   link configuration the artifact's), at one waterfall point each, its
   BLER held within 4σ of the artifact's and the entry point it launched
   printed;
   one point of the error-floor campaign on qc1944_r56
   (``docs/artifacts/20260821-115110_error_floor_qc1944_r56.json``: 6.25
   dB, all-zero codewords, BPSK, 8 × 32768 frames through ``bp_decode``),
   flooding-20's and layered-10's FER each within 4σ of the artifact's, on
   the _cw entry points; and the forms the _gw and _rw kernels took over
   from the full messages on qc1944_r34 and r56, each through
   ``run_sweep`` at its code's TPU-sweep point (Eb/N0 3.0 and 3.5 dB,
   batch 32768, 2-3 steps), failing unless it launched its _gw or _rw
   entry point: min-sum layered-20 at G = 4 and 2, layered-20 G = 4 with
   ``es_mode='freeze'``, layered-6 G = 4 with random per-edge weights,
   sum-product layered-20 with ``es_mode='auto'``, layered-20 with
   ``es_mode='freeze'`` and layered-20 G = 4, and the two forms the _lw
   kernels took over on qc1944_r56, sum-product flooding-20 and its
   ``es_mode='freeze'``; the G = 4 BLER between min-sum layered-20's and
   flooding-20's on the same frames within 4σ, sum-product's at or below
   min-sum layered-20's within 4σ; and the other 16 entry points of the
   _lw kernels (``LW_ROWS``: 4-bit messages, per-edge weights, bf16 and
   int8 storage) each decoded once through ``bp_decode`` on qc1944_r56's
   channel at its TPU-sweep point, batch 32768, failing unless exactly its
   entry point launched once;
3e. the bigcode scale run (``ldpc_sims_tpu_torch.examples.bigcode``) at
   full width on qc8448_r12 and qc12288_r12, batch 16384, its pipe cut
   from 16 to 4 decodes: the rates of flooding-20 f32 and layered-10 at
   f32, bf16 and int8, and its paired-noise BER at 1.75 and 2.25 dB (8 ×
   16384 all-zero codewords): the f32 flooding-20 and layered-10 BER
   within 4σ of the JAX package's artifact, σ = √2 × the standard error
   from the per-frame error counts, and the bf16 and int8 layered-10 BER
   at most 1.2 × the f32 layered-10 BER plus 4σ of their paired
   per-frame difference; a profile of one qc12288 layered-10 step at each
   storage type;
3f. ``sweep`` with no flags (the JAX CLI's defaults: ref6432, QPSK/OFDM-32,
   sum-product-ref-3, clamp 20, batch 4096, on the gather backend) at 0,
   3 and 6 dB, 8 steps a point, each coded BER within 4σ + 10% of
   ``BASELINE.md`` table A; the ``small-cpu`` preset at 2 dB and the
   ``reference`` preset at 6 dB;
3g. the dense backend, pair-flavor weights and the sweep's outputs:
   ``bp_decode(backend='dense')`` beside the gather backend on ref6432
   (sum-product-ref-3, clamp 20) and peg128_64 (min-sum-10) at batch
   32768 and on the native PEG code ``make_regular_ldpc(4096, 2048, 3,
   seed=7, backend='native')`` (Ec = 14336 > 1024 padded edges: the
   factored routing; min-sum-20) at batch 8192, all on the BPSK channel
   of all-zero codewords at 2.0 dB: hard bits equal wherever |posterior|
   > 1e-3, posteriors within 1e-3 relative + 1e-5 absolute in every
   codeword both decode (on peg4096 in all but one in a thousand of
   them), the frame errors equal; the dense posteriors with
   TF32 on (``torch.backends.cuda.matmul.allow_tf32``, shown to change a
   plain float32 product) equal to those with it off; early-stop freeze
   iterations equal to the gather backend's, and the bits of every
   codeword that stopped before the budget (the others' bits their fixed
   decode's); ms per decode of each backend; pair-flavor weights on peg128_64 (random in [0.7, 1.3]:
   ``auto`` equal to ``backend='gather'``; identity: hard bits equal to the
   unweighted decode wherever |posterior| > 1e-3, posteriors within the
   tolerance) and on wifi1944 (``auto`` on the card goes to the gather
   backend and launches no kernel); one ``python -m ldpc_sims_tpu_torch
   sweep --profile`` (wifi1944 flooding-20, batch 32768, one point, 2
   steps), its ``metrics.jsonl`` holding ``sweep-step``, ``sweep-point``
   and ``sweep-phases`` with ``compile+first-step``, its ``registry.jsonl``
   a ``sweep`` record, its Chrome trace naming ``minsum_qc_flooding_cs``
   (its top kernels printed);
3h. ``evaluate`` as a user runs it: ``python -m ldpc_sims_tpu_torch
   evaluate`` on wifi1944, QPSK/OFDM-32, min-sum flooding-20, ``--qbits 3``
   (global AGC), batch 32768, at 1.5 and 2.0 dB, with ``--ckpt`` a
   JAX-format checkpoint this phase writes of a seeded ``LLRestimator``
   (and reads back equal first, bfloat16 and int64 leaves included): the
   flooding kernel launched three times a point (Traditional, Quantized,
   NN), the curves finite and printed, the Traditional and Quantized
   BLER and BER within 4σ of ``run_sweep``'s on the same links; the
   ``LLRestimator`` and ``LLRestimatorTanh`` forwards on 4096 rows, card
   against CPU, within 1e-4 of the largest LLR, and the first's time at
   the point's 995,328 rows; ``python -m torch.distributed.run
   --standalone --nproc_per_node 1 -m ldpc_sims_tpu_torch sweep
   --multihost`` (NCCL) with its counts equal to ``sweep``'s; one
   ``scaling-probe`` row (32768 a rank); ``run_grid`` over two points
   equal to each point's ``mc_step``;
3i. training on the card: ``python -m ldpc_sims_tpu_torch train-minsum``
   as ``docs/artifacts/20260820_minsum_trained.json`` ran it (wifi1944
   layered-10, no clamp, 1.25-2.5 dB, 120 adam steps at batch 256), its
   gradient decodes launching no kernel and the mean of its last 10 losses
   below 0.6 × its first 10's; its checkpoint through ``sweep
   --schedule-ckpt`` at layered-10 beside plain layered-10 (phase 3's
   points, steps and seed), ``minsum_qc_layered`` launched once a step with
   the trained α/β table and the trained coded BER at 1.5 dB below a third
   of plain's (the artifact's numbers printed beside), and the
   decoded-BER probe with the trained ms arrays on ``minsum_qc_layered``
   (one launch); the roll training
   step's time and a profile of it (its idle share); ``train_neural_bp``
   with the K6 recipe cut to 16 steps (per-edge layered-6, no clamp,
   1.25-3.5 dB, adam at 0.002, batch 192) and probes of 32768 frames at
   2.0 and 2.5 dB, each probe decode on ``minsum_qc_layered_w`` and
   nothing else launched, a first probe at the all-ones init within 4σ of
   plain layered-6 through ``bp_decode``; ``train_llr`` at the CLI's
   defaults on ref6432 on the card and on the CPU from one dataset and one
   CPU-drawn init, params within 1e-3 of max|param| and losses within
   1e-4 relative; ``train-llr`` and ``generate-data``; ``train-joint`` as
   ``docs/artifacts/20260820_joint_before_after.json`` ran it (ref6432,
   3-bit ADC, 3 iterations, clamp 20, 5 dB, adam at 2e-5, batch 2048) for
   3 epochs, its losses and holdout BER finite and its checkpoint's key
   tree JAX's (``optax.multi_transform`` over two adams);
3j. the rest of the library and the CLI: ``train-grid`` then
   ``evaluate-grid`` on ref6432 (qbits 3, clipdb 0, 0/3/6 dB, training
   cut to 2 epochs, the CLI's decoder defaults) at 65536 codewords, the
   Traditional and quantized columns within 4/√(frames in error),
   relative, of ``docs/artifacts/20260820_grid_sgd_family.json``, and a
   resumed ``train-grid`` that trains no cell; the same flow on wifi1944
   with ``--method min-sum --iters 20`` at batch 32768, failing unless
   ``minsum_qc_flooding`` launched three times a cell;
   ``ldpc_sims_tpu_torch.examples.de_thresholds`` on qc1944_r56 (8192
   samples, batch 8192): the 20-iteration min-sum threshold and the
   measured 1e-3 crossing within 0.15 dB of
   ``docs/artifacts/20260821-112609_de_thresholds.json``'s 5.469 and
   5.762, the DE wall time printed; the error-floor campaign
   (``examples/error_floor_campaign``) on wifi1944 at 2.5 dB, batch 32768,
   64 steps, every schedule of the committed registry, flooding-20's and
   edge-layered-6's FER within 4/√(frames in error) of
   ``docs/artifacts/20260821-113932_error_floor.json``, nothing under
   ``docs/artifacts/`` changed; ``noise-study``, ``evaluate-joint`` (a
   seeded ``Joint``, 3-bit ADC) and ``code-info --code wifi648 --de``
   once each; ``examples/joint_before_after`` with its joint training
   cut from 40 epochs to 3, its curves finite and printed beside
   ``docs/artifacts/20260820_joint_before_after.json``'s;
3k. the training and study examples through their ``run()``
   (``ldpc_sims_tpu_torch.examples``), their training cut
   (``EXAMPLE_CUTS``) and their evaluations at the JAX scripts' budget
   (31 steps of 32768 paired BPSK frames a point), each failing unless
   it launched exactly its evaluations' and probes' kernels (the
   gradient decodes none): ``quantized_llr_study`` at 4096 codewords
   and 300 epochs, its Traditional coded BER at 0 and 6 dB within 4σ +
   10% of ``BASELINE.md`` table A; ``tanh_family`` at 60 of 600 epochs,
   the arms' estimator-independent columns equal and, pooled over the
   six points, within the larger of 4/√(frames in error) and 4σ of
   ``docs/artifacts/20260821-054923_tanh_family.json``;
   ``train_minsum_1944`` (32 of 120 steps) with plain and sum-product
   layered-10 and flooding-20 at 1.5, 1.75 and 2.0 dB held so to
   ``20260820_minsum_trained.json`` (σ from this run's per-frame counts)
   and the trained layered-10 below plain at 1.5 dB;
   ``train_minsum_short`` (K = 6, 8; 16 steps a K), flooding-20 at 1.75
   and 2.25 dB held to ``20260820_minsum_short.json``;
   ``train_minsum_tail7`` (16 of 3000 steps), its flooding-20 control
   held to the K6 record's; ``train_edge_1944`` (16 of 300 steps),
   flooding-12 and flooding-20 held to ``20260821-063306_edge1944.json``;
   ``train_edge_layered_1944`` (16 of 1500 steps, ``EL_JOINT``),
   flooding-20, plain layered-6 and trained layered-8 held to
   ``20260821-104318_edge_layered1944_K6.json`` at 1.75 and 2.25 dB
   (2.75 and 3.25 dB recorded), its registry copy read back by the
   campaign's ``schedules_from_registry``; nothing under
   ``docs/artifacts/`` changed;
4. at batch 32768, holds each kernel against its plain version once more,
   times both with CUDA events and prints the ``kernels`` JSON line with
   each kernel's bound: first ``encode@wifi1944``, the GF(2) encode kernel
   (exactly the plain version; its time, the plain version's, the float32
   product alone as ``library_ms``, its bound in bytes and LOP3, its
   launches in one ``mc_step``, which must be 1), then one row per decode
   kernel with the launches of its own main-path run, and a row ``minsum_qc_layered@es_auto`` for the layered
   kernel's launches on the es-auto path, timed as one probe chunk at 3.5
   dB (the ``hard_unsat`` probe and the ``done_in`` pass); the four
   sum-product kernels, at wifi1944 and again at the wifi648-sweep
   preset's shape (``name@wifi648``: wifi648 at 2.0 dB, batch 4096), and
   ``minsum_qc_flooding@msgq4`` (the quantized form, with the
   quantized-minsum run's launches), ``minsum_qc_flooding@evaluate`` (a
   decode of each of an evaluate point's three LLR sets, with phase 3h's
   launches, three a point), bound by the f32 and
   special-function-unit instructions counted in the SASS of their edge
   sequence; ``minsum_qc_layered_w`` (the K6 decoder),
   ``minsum_qc_flooding_w`` (flooding-12, random weights) and
   ``minsum_qc_layered@g4`` (layered-20, G = 4) and
   ``sumproduct_qc_layered@g4``, each with the launches of its phase 3d
   run; layered-20 at each group size G = 1, 2, 3, 4, 6, 12 with its entry
   point, bound and the full-message kernel's recorded time; the rows
   ``minsum_qc_layered_es@qc1944_r23``, ``_r34``, ``_r56`` (their phase 3d
   configuration and launches, on the wide word, beside the full-message
   kernel's recorded time) and the error-floor point's
   ``minsum_qc_flooding@qc1944_r56`` (flooding-20) and
   ``minsum_qc_layered@qc1944_r56`` (layered-10), with the launches of
   their phase 3d run; the seven forms the _gw and _rw kernels took over
   on qc1944_r34 and r56 (``WIDE_ROWS``: kernels/compare.py's rows, beside
   the full-message kernels' recorded times), with the launches of their
   phase 3d runs; the trained decoders of phase 3i,
   ``minsum_qc_layered@train-minsum`` (the trained layered-10 schedule at
   1.5 dB) and ``minsum_qc_layered_w@train-probe`` (the probe's decode:
   the trained per-edge layered-6 on its BPSK channel at 2.0 dB), with
   the launches of their phase 3i runs; phase 3j's
   ``minsum_qc_flooding@evaluate-grid`` (a decode of each of a wifi1944
   cell's three LLR sets, three launches a cell),
   ``minsum_qc_flooding@error-floor``, ``minsum_qc_layered@error-floor``
   and ``minsum_qc_layered_w@error-floor`` (timed as flooding-20,
   layered-10 and edge-layered-6 on the campaign's frames, with the
   launches of every schedule of its run) and
   ``minsum_qc_flooding@de-crossing`` (qc1944_r56 flooding-20 at batch
   8192 at the measured crossing, the waterfall's launches); phase 3k's
   ``sumproduct_qc_layered@train-minsum-1944`` (sum-product layered-10),
   ``minsum_qc_layered@tail7`` (the tuned layered-7 table),
   ``minsum_qc_flooding_w@train-edge`` (the trained flooding-12 weights)
   and ``minsum_qc_layered_w@train-edge-layered`` (the trained layered-6
   weights with their α/β table), each on the examples' BPSK frames at
   2.0 dB with the launches of its example's run;
   the 16 ``LW_ROWS`` (the _lw kernels' other entry points at phase 3d's
   shape, each exactly equal to the plain version, whose one run is its
   time); then the times of both drivers; then the storage rows with the launches
   of phase 3e: ``minsum_qc_layered@bf16`` and ``@int8`` (trained
   layered-8 on wifi1944, beside ``minsum_qc_layered``), and at batch
   16384 on qc12288 ``minsum_qc_layered@qc12288`` at f32, bf16 and int8
   and ``minsum_qc_flooding@qc12288`` (flooding-20 f32), the storage rows
   bound with the conversion instructions counted in the SASS of probes of
   the source's load and store helpers; the min-sum flooding forms that
   no main path launches (flooding-20 at bf16 and int8, with its count,
   its ``done_in`` pass), the error-floor campaign's decoders on
   qc1944_r34/r56 and qc648_r34/r56 at its first SNR (flooding-20,
   layered-10 and the probe driver, on the wide word's kernels) and
   flooding-20 and layered-20 on qc1944_r56 at each storage type, and the
   sum-product forms no main path launches
   (per-edge weights, 4-bit messages, bf16 and int8 storage, each
   schedule), each equal to the plain version, printed with their
   bounds (and the plain version's time, beside the flooding storage
   forms and the sum-product ones); the min-sum and sum-product rows
   print the earlier
   full-message designs' recorded times beside theirs, and the SASS
   loops of both designs of each kernel, serial-C and flooding (and the
   wide word's), give their shared-memory instructions an edge and each
   kernel's code size; and one short sweep of the
   launch tuner (``kernels/tune.py``). Each row of the ``kernels`` line
   names the CUDA entry point its launches ran (``entry``; ``_cs`` on the
   compressed check state, ``_cw`` on its wide word, ``_sr`` with the
   sum-product slots in registers, ``_gs`` group-serial, ``_rw`` and
   ``_gw`` the last two on the wide rows), and each
   main-path run prints its
   launches per entry point.

Exits non-zero, printing no result, when no CUDA device is present, when
the package is not beside this script, or when any phase fails. The last
line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCHEDULES = os.path.join(ROOT, "docs", "artifacts",
                         "minsum_trained_schedules.json")
TOL = 1e-4  # posterior tolerance, absolute and relative
HARD_MARGIN = 1e-3  # hard bits compared where |posterior| exceeds this
# two backends' posteriors, as tests/test_torch_gather.py holds them
GATHER_RTOL, GATHER_ATOL = 1e-3, 1e-5
BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM f32 outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as 2; none of the decode's operations is one, so it issues
# at most half that many
F32_OPS_PER_S = 67e12 / 2
# f32 operations one min-sum iteration needs per edge whatever its
# parameters: the v2c subtract, |v|, the negative count, the two-minima
# update (2), the exclusive-sign parity, the exclusive-minimum select and
# the sign multiply; then the posterior accumulate for flooding (1) or the
# message difference and posterior update for layered (2)
OPS_PER_EDGE_ITER = {"flooding": 8 + 1, "layered": 8 + 2}
# one syndrome check per edge: the sign test and the parity update
OPS_PER_EDGE_CHECK = 2
# H100 SXM special-function units: 16 results per clock per SM, an eighth
# of the f32 issue rate
SFU_OPS_PER_S = F32_OPS_PER_S / 8
# f32 operations one sum-product iteration needs per edge besides its
# transcendental sequence (counted from the SASS): the v2c subtract, the
# negative count, the Σlt accumulate, the exclusive-sign parity and the
# sign multiply; then the posterior as for min-sum
SP_OPS_PER_EDGE_ITER = {"flooding": 5 + 1, "layered": 5 + 2}
# the kernels line's row for minsum_qc_layered's launches on the
# es_mode='auto' path (its hard_unsat probe and done_in pass)
ES_AUTO_ROW = "minsum_qc_layered@es_auto"
# the kernels line's row for the 4-bit quantized flooding kernel
MSGQ_ROW = "minsum_qc_flooding@msgq4"
# the kernels line's row for the flooding kernel's launches on the
# evaluate path (three decodes a point: Traditional, Quantized, NN)
EVAL_ROW = "minsum_qc_flooding@evaluate"
# the kernels line's rows for the trained decoders of phase 3i: the
# train-minsum schedule's sweep (layered-10 with its α/β table) and the
# neural-BP trainer's decoded-BER probe (per-edge layered-6)
TRAIN_MINSUM_ROW = "minsum_qc_layered@train-minsum"
TRAIN_PROBE_ROW = "minsum_qc_layered_w@train-probe"
# the kernels line's rows for phase 3j: the flooding kernel on the
# evaluate-grid path (three decodes a cell), the campaign's three kernels
# on the error-floor path and the flooding kernel in the DE example's
# measured waterfall
GRID_ROW = "minsum_qc_flooding@evaluate-grid"
FLOOR_ROWS = {"minsum_qc_flooding": ("minsum_qc_flooding@error-floor",
                                     "flooding-20"),
              "minsum_qc_layered": ("minsum_qc_layered@error-floor",
                                    "layered-10"),
              "minsum_qc_layered_w": ("minsum_qc_layered_w@error-floor",
                                      "edge-layered-6")}
DE_ROW = "minsum_qc_flooding@de-crossing"
# phase 3j's anchors: the committed ref6432 family's grid (65536 codewords
# a cell, qbits 3, clipdb 0), the DE thresholds' record and the error-floor
# campaign's record on wifi1944, with the schedules held at its point
GRID_ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                             "20260820_grid_sgd_family.json")
GRID_SNRS = (0.0, 3.0, 6.0)
DE_ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                           "20260821-112609_de_thresholds.json")
DE_CODE = "qc1944_r56"
FLOOR_ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                              "20260821-113932_error_floor.json")
EF_SNR = 2.5
EF_HELD = ("flooding-20", "edge-layered-6")
JOINT_ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                              "20260820_joint_before_after.json")
# phase 3k: the training and study examples, each held to its committed
# record (paired BPSK frames, all-zero codewords; each arm's BER within the
# larger of 4/√(frames in error) and 4σ of the difference of two estimates
# at the same exposure, σ the standard error from this run's per-frame
# counts), and the kernels line's row of each new path: the example, its
# kernel and the row
EXAMPLE_ROWS = {
    "train_minsum_1944": ("sumproduct_qc_layered",
                          "sumproduct_qc_layered@train-minsum-1944"),
    "train_minsum_tail7": ("minsum_qc_layered", "minsum_qc_layered@tail7"),
    "train_edge_1944": ("minsum_qc_flooding_w",
                        "minsum_qc_flooding_w@train-edge"),
    "train_edge_layered_1944": ("minsum_qc_layered_w",
                                "minsum_qc_layered_w@train-edge-layered"),
}
MINSUM_ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                               "20260820_minsum_trained.json")
SHORT_ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                              "20260820_minsum_short.json")
EDGE_ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                             "20260821-063306_edge1944.json")
EDGE_LAYERED_ARTIFACT = os.path.join(
    ROOT, "docs", "artifacts", "20260821-104318_edge_layered1944_K6.json")
TANH_ARTIFACT = os.path.join(ROOT, "docs", "artifacts",
                             "20260821-054923_tanh_family.json")
# the tanh family's estimator-independent columns and the frame count that
# bounds each: the coded columns by their own BLER's frames in error, the
# uncoded one by every frame
TANH_HELD = {"uncoded_ber": None, "coded_ber": "coded_bler",
             "coded_bler": "coded_bler", "coded_ber_qllr": "coded_bler_qllr",
             "coded_bler_qllr": "coded_bler_qllr"}
# the record's sum-product layered-10 at 2.0 dB came from the JAX package's
# Pallas kernel, whose arithmetic (ldpc_sims_tpu/kernels/minsum_qc.py:62-78,
# :333-343) rounds log(1 − e^−a) to 0 for a ≳ 16.6 in f32, where the exact
# rule (the JAX roll backend's and the port's) keeps −e^−a: more bit errors
# a failing frame. There the port's BER is held at or below the record's,
# and the plain decode with the Pallas arithmetic two-sided to it
SP_SATURATED = ("sumproduct_layered10", "2.0")
# the training cuts (roll steps of ~0.4 s each on the card; PERF.md §4)
EXAMPLE_CUTS = dict(ms_train_steps=32, short_train_steps=16, t7_steps=16,
                    edge_steps=16, el_steps=16, tanh_epochs=60,
                    quantized_codewords=4096, quantized_epochs=300)
# phase 3i's recipes: train-minsum as docs/artifacts/
# 20260820_minsum_trained.json ran it (wifi1944 layered-10, no clamp, Es/N0
# 1.25-2.5 dB, 120 adam steps at 0.02, batch 256) and that artifact's
# info-bit BER at 1.5 dB, trained and plain; the K6 recipe of
# docs/artifacts/20260821-102413_edge_layered1944_K6.json (per-edge
# layered-6, no clamp, 1.25-3.5 dB, adam at 0.002, batch 192) cut from
# 1500 steps to 2 epochs of 8 batches; train-joint as
# docs/artifacts/20260820_joint_before_after.json ran it (ref6432, 3-bit
# ADC, 3 iterations, clamp 20, 5 dB, adam at 2e-5, batch 2048, minibatch
# 512) cut from 40 epochs to 3
MINSUM_TRAIN_FLAGS = [
    "train-minsum", "--code", "wifi1944", "--schedule", "layered",
    "--iters", "10", "--clamp", "0", "--snr-low", "1.25", "--snr-high",
    "2.5", "--steps", "120", "--batch", "256", "--lr", "0.02",
    "--optimizer", "adam"]
MINSUM_TRAINED_BER = {"trained": 0.006859853671838701,
                      "plain": 0.0461899395183977}
K6_RECIPE = dict(lr=0.002, batch=192, snr=(1.25, 3.5), batches=8, epochs=2)
JOINT_TRAIN_FLAGS = [
    "train-joint", "--qbits", "3", "--iters", "3", "--clamp", "20",
    "--snrdb", "5", "--optimizer", "adam", "--lr", "2e-5", "--batch",
    "2048", "--epochs", "3"]
# f32 operations of the NN estimator's forward a row at OFDM size 32: the
# four products (64·64 + 64·512 + 2·512·512 + 512·64 multiply-adds, 2
# each), at the H100 SXM's 67 TFLOP/s f32 outside the tensor cores (TF32
# stays off)
NN_OPS_PER_ROW = 2 * (64 * 64 + 64 * 512 + 2 * 512 * 512 + 512 * 64)
F32_FMA_OPS_PER_S = 67e12
# the four sum-product entry points, each with a row at wifi1944 (batch
# 32768) and one at the wifi648-sweep preset's shape that launches it
# (name@wifi648: wifi648 at 2.0 dB, batch 4096)
SP_KERNELS = ("sumproduct_qc_flooding", "sumproduct_qc_layered",
              "sumproduct_qc_flooding_es", "sumproduct_qc_layered_es")
# BLER anchors of the JAX package's committed curves at 2.0 dB, (BLER,
# frames): wifi648-sweep (docs/artifacts/r5_sweeps/20260821-124859_curves.json)
# and quantized-minsum (docs/artifacts/20260817-105931_curves_msgq{b}.json)
WIFI648_SWEEP_BLER = (0.007110595703125, 32768)
QUANTIZED_BLER = {3: (0.99560546875, 4096), 4: (0.606201171875, 4096),
                  5: (0.232666015625, 4096)}
# the probe kernels whose SASS gives the per-edge instruction counts: they
# call the decode source's own device functions, built with its flags
EDGE_PROBE = r"""
extern "C" __global__ void probe_sp_edge(const float* v, const float* t,
                                         float* y) {
  const int i = threadIdx.x;
  y[i] = sp_mag(fminf(t[i] - sp_lt(v[i]), -1e-12f));
}
extern "C" __global__ void probe_msgq(const float* v, float* y, float step,
                                      float clip) {
  const int i = threadIdx.x;
  y[i] = quantize(v[i], step, clip);
}
extern "C" __global__ void probe_copy(const float* x, float* y, float s) {
  const int i = threadIdx.x;
  y[i] = x[i];
}
extern "C" __global__ void probe_ld_bf16(const __nv_bfloat16* x, float* y,
                                         float s) {
  const int i = threadIdx.x;
  y[i] = lift(x[i], s);
}
extern "C" __global__ void probe_ld_i8(const int8_t* x, float* y, float s) {
  const int i = threadIdx.x;
  y[i] = lift(x[i], s);
}
extern "C" __global__ void probe_st_bf16(const float* x, __nv_bfloat16* y,
                                         float s) {
  const int i = threadIdx.x;
  y[i] = store<__nv_bfloat16>(x[i], s);
}
extern "C" __global__ void probe_st_i8(const float* x, int8_t* y, float s) {
  const int i = threadIdx.x;
  y[i] = store<int8_t>(x[i], s);
}
"""
# the kernels line's rows for the layered kernels' launches on the
# --layered-group 4 paths (layered-20, G = 4), min-sum and sum-product
G4_ROW = "minsum_qc_layered@g4"
SP_G4_ROW = "sumproduct_qc_layered@g4"
# layered-20 min-sum on wifi1944 at batch 32768 and 1.5 dB by group size
# on the full-message group-serial kernel of the tree before the _gs
# kernels (G = 1: the compressed serial-C kernel, unchanged), printed
# beside this run's: the old turns of `python -m
# ldpc_sims_tpu_torch.kernels.compare` of that tree (commit 1251547)
# against the _gs kernels, on an NVIDIA H100 80GB HBM3 at 700 W
FULL_MESSAGE_GROUP_MS = {1: 10.083, 2: 36.089, 3: 25.985, 4: 25.212,
                         6: 20.589, 12: 19.791}
# the committed TPU sweeps of the codes beyond the compressed state's
# narrow word (rows of degree 9-18: the wide word's _cw kernels) and the
# waterfall point each is held to
HIGH_RATE = {"qc1944_r23": 3, "qc1944_r34": 4, "qc1944_r56": 5}
# the flags those sweeps ran with, on their Eb/N0 grid
HIGH_RATE_FLAGS = ("--method", "min-sum", "--schedule", "layered", "--iters",
                   "20", "--clamp", "20", "--early-stop", "--es-mode",
                   "freeze", "--snr", "1:4.5:8", "--snr-unit", "eb")
HIGH_RATE_SWEEP = os.path.join(ROOT, "docs", "artifacts",
                               "20260821_{}_sweep_tpu.json")
# one point of the error-floor campaign on qc1944_r56
# (docs/artifacts/20260821-115110_error_floor_qc1944_r56.json: all-zero
# codewords, BPSK r = 1 + σ·n with σ = snr^-½, LLR = −2r/σ², every
# coded bit counted; examples/error_floor_campaign.py:89-99): its SNR, and each
# decoder's FER over its frames, with the kernels line's row of its decode
FLOOR_CODE, FLOOR_SNR = "qc1944_r56", 6.25
# the campaign's first SNR on each code it ran beyond the narrow word
# (docs/artifacts/20260821-11*_error_floor_qc*.json)
FLOOR_SHAPES = {"qc1944_r34": 5.25, "qc1944_r56": 6.25, "qc648_r34": 5.5,
                "qc648_r56": 6.5}
FLOOR_FER = {
    "flooding-20": (0.0020148595174153644, 31457280,
                    dict(iterations=20, schedule="flooding"),
                    "minsum_qc_flooding@qc1944_r56"),
    "layered-10": (0.0021327336629231772, 31457280,
                   dict(iterations=10, schedule="layered"),
                   "minsum_qc_layered@qc1944_r56"),
}
# the committed per-edge layered-6 decoder for wifi1944 and its measured
# coded BER on its own BPSK-AWGN channel (all n bits counted)
K6_NPZ = os.path.join(ROOT, "docs", "artifacts", "edge_layered_1944_K6.npz")
K6_BER = {1.75: 0.002604267439898561, 2.25: 9.040017218509392e-05}
K6_PLAIN_BER = {1.75: 0.02259009181622346, 2.25: 0.0006125619904257206}
# flooding-20's info-bit BER in docs/artifacts/20260820_minsum_trained.json
# (examples/train_minsum_1944.py:63-114: all-zero codewords, BPSK r = 1 +
# σ·n with σ = snr^-½, llr = −2r/σ², the first k bits counted) and the info
# bits of each of its points
FLOODING20_BER = {1.5: 0.04572371393343248, 2.0: 0.0011993047647642042}
FLOODING20_BITS = 987365376
# the bigcode artifact's BER (docs/artifacts/20260821-121129_bigcode.json:
# 8 x 16384 all-zero codewords per point, every bit counted)
BIGCODE_BER = {
    ("qc8448_r12", 1.75): (0.0162928303082784, 0.017248438163237137),
    ("qc8448_r12", 2.25): (0.00015566475463635993, 0.0002448685241468025),
    ("qc12288_r12", 1.75): (0.00286795881887277, 0.0032545017699400582),
    ("qc12288_r12", 2.25): (8.999680479367575e-06, 1.0357548793156942e-05),
}
# BASELINE.md table A (the reference's stored run of ref6432, QPSK/OFDM-32,
# sum-product-ref-3, clamp 20): coded BER at the points the no-flag sweep
# runs
TABLE_A = {0.0: 7.271e-2, 3.0: 1.142e-2, 6.0: 3.419e-4}
# the times of the kernels' rows with full messages and the plan in shared
# memory, the designs before the compressed check state, the sum-product
# slots in registers and the _gs kernels (PERF.md §6, this script on an
# NVIDIA H100 80GB HBM3 at 700 W, the last run of each earlier design;
# sumproduct_qc_layered@g4 from `python -m
# ldpc_sims_tpu_torch.kernels.compare`, which times both designs in one
# call), printed beside this run's
FULL_MESSAGE_MS = {
    "sumproduct_qc_flooding": 42.307, "sumproduct_qc_layered": 48.532,
    "sumproduct_qc_flooding_es": 17.294, "sumproduct_qc_layered_es": 11.652,
    "minsum_qc_flooding": 15.898, "minsum_qc_flooding_es": 8.458,
    "minsum_qc_flooding@msgq4": 18.520, "minsum_qc_flooding_w": 13.618,
    "minsum_qc_flooding@qc12288": 41.132,
    "minsum_qc_layered": 5.989, "minsum_qc_layered@es_auto": 3.743,
    "minsum_qc_layered@qc12288": 17.039, "minsum_qc_layered_es": 4.995,
    "minsum_qc_layered_w": 11.864, "minsum_qc_layered@g4": 25.215,
    "sumproduct_qc_layered@g4": 56.299,
    "minsum_qc_layered@bf16": 5.505, "minsum_qc_layered@int8": 5.851,
    "minsum_qc_layered@qc12288-bf16": 13.834,
    "minsum_qc_layered@qc12288-int8": 15.277,
    # the high-rate codes' rows on the full-message kernels the wide word
    # replaced (this script's run on commit c5ad6e2; the error-floor rows:
    # the old turns of `python -m ldpc_sims_tpu_torch.kernels.compare` of
    # that commit)
    "minsum_qc_layered_es@qc1944_r23": 5.328,
    "minsum_qc_layered_es@qc1944_r34": 4.471,
    "minsum_qc_layered_es@qc1944_r56": 4.342,
    "minsum_qc_flooding@qc1944_r56": 12.479,
    "minsum_qc_layered@qc1944_r56": 5.085,
    # the forms the _gw and _rw kernels replaced on the high-rate codes (and
    # sum-product flooding, which keeps the full-message kernel there,
    # 35.931 ms):
    # the old turns of `python -m ldpc_sims_tpu_torch.kernels.compare` of
    # commit 9be01e8 (the full-message kernels)
    "minsum_qc_layered@qc1944_r34-g4": 17.799,
    "minsum_qc_layered@qc1944_r34-g2": 20.874,
    "minsum_qc_layered_es@qc1944_r56-g4": 8.758,
    "minsum_qc_layered_w@qc1944_r34-g4": 8.861,
    "sumproduct_qc_layered@qc1944_r56": 38.687,
    "sumproduct_qc_layered_es@qc1944_r34": 10.243,
    "sumproduct_qc_layered@qc1944_r34-g4": 44.729,
    # the full-message kernel the _lw kernels replaced: flooding-20 (the
    # same step 1 of commit 9be01e8) and its early stop (the old turns of
    # `python -m ldpc_sims_tpu_torch.kernels.compare` of commit 8f8e08f)
    "sumproduct_qc_flooding@qc1944_r56": 35.931,
    "sumproduct_qc_flooding_es@qc1944_r56": 15.048,
}
# the forms the _gw and _rw kernels took over from the full-message
# kernels on the high-rate codes: the rows of kernels/compare.py (batch
# 32768, hard bits, no clamp, QPSK/OFDM-32 at each code's TPU-sweep
# point), their kernel form and decode, and the phase 3d run that drives
# each through run_sweep (its `sweep` flags beside --schedule layered
# --clamp 0, its Eb/N0 point; weights: random per-edge weights)
WIDE_ROWS = {
    "minsum_qc_layered@qc1944_r34-g4": (
        "qc1944_r34", dict(iterations=20, layered_group=4),
        ("--method", "min-sum", "--iters", "20", "--layered-group", "4")),
    "minsum_qc_layered@qc1944_r34-g2": (
        "qc1944_r34", dict(iterations=20, layered_group=2),
        ("--method", "min-sum", "--iters", "20", "--layered-group", "2")),
    "minsum_qc_layered_es@qc1944_r56-g4": (
        "qc1944_r56", dict(iterations=20, layered_group=4, early_stop=True),
        ("--method", "min-sum", "--iters", "20", "--layered-group", "4",
         "--early-stop", "--es-mode", "freeze")),
    "minsum_qc_layered_w@qc1944_r34-g4": (
        "qc1944_r34", dict(iterations=6, layered_group=4, weights=True),
        ("--method", "min-sum", "--iters", "6", "--layered-group", "4")),
    "sumproduct_qc_layered@qc1944_r56": (
        "qc1944_r56", dict(iterations=20, method="sum-product"),
        ("--method", "sum-product", "--iters", "20", "--early-stop",
         "--es-mode", "auto")),
    "sumproduct_qc_layered_es@qc1944_r34": (
        "qc1944_r34", dict(iterations=20, method="sum-product",
                           early_stop=True),
        ("--method", "sum-product", "--iters", "20", "--early-stop",
         "--es-mode", "freeze")),
    "sumproduct_qc_layered@qc1944_r34-g4": (
        "qc1944_r34", dict(iterations=20, method="sum-product",
                           layered_group=4),
        ("--method", "sum-product", "--iters", "20", "--layered-group",
         "4")),
    # the _lw kernels (sum-product flooding with one lt an edge)
    "sumproduct_qc_flooding@qc1944_r56": (
        "qc1944_r56", dict(iterations=20, method="sum-product",
                           schedule="flooding"),
        ("--method", "sum-product", "--iters", "20")),
    "sumproduct_qc_flooding_es@qc1944_r56": (
        "qc1944_r56", dict(iterations=20, method="sum-product",
                           schedule="flooding", early_stop=True),
        ("--method", "sum-product", "--iters", "20", "--early-stop",
         "--es-mode", "freeze")),
}
# the other 16 entry points of the _lw kernels: each form (4-bit
# messages, random per-edge weights on flooding-12, early stop with 4-bit
# messages) at each storage type, and the fixed and early-stop forms at
# bf16 and int8, decoded once each through bp_decode in phase 3d at
# qc1944_r56's TPU-sweep point (batch 32768) and timed in phase 4: row →
# (form, storage)
LW_CODE = "qc1944_r56"
LW_FORMS = {"": {}, "_es": dict(early_stop=True), "_msgq": dict(msg_qbits=4),
            "_es_msgq": dict(early_stop=True, msg_qbits=4),
            "_w": dict(weights=True), "_w_msgq": dict(weights=True,
                                                      msg_qbits=4)}
LW_STORAGE = {"": "float32", "-bf16": "bfloat16", "-int8": "int8"}
LW_ROWS = {f"sumproduct_qc_flooding{f}@{LW_CODE}{d}": (f, d)
           for f in LW_FORMS for d in LW_STORAGE
           if f"sumproduct_qc_flooding{f}@{LW_CODE}{d}" not in WIDE_ROWS}
# each high-rate code's TPU-sweep point in Eb/N0 (its Es/N0 in
# kernels/compare.py's HIGH_RATE_SWEEP)
WIDE_EBN0 = {"qc1944_r34": 3.0, "qc1944_r56": 3.5}
# the two runs held to min-sum layered-20 on the same frames
G4_WIDE_ROW = "minsum_qc_layered@qc1944_r34-g4"
SP_WIDE_ROW = "sumproduct_qc_layered@qc1944_r56"
KERNEL_SOURCE = "ldpc_sims_tpu_torch/kernels/csrc/minsum_qc.cu"
TPU_KERNEL = "ldpc_sims_tpu/kernels/minsum_qc.py:788"
# the GF(2) encode kernel's row: it replaces no Pallas kernel (the JAX
# package's encode is an XLA int8 dot)
ENCODE_ROW = "encode@wifi1944"
ENCODE_SOURCE = "ldpc_sims_tpu_torch/kernels/csrc/encode.cu"
# H100 SXM 32-bit bitwise operations (LOP3): 64 results per clock per SM,
# 132 SMs at the 1.98 GHz boost clock
INT_OPS_PER_S = 64 * 132 * 1.98e9


def ptxas_entries(report: str) -> dict:
    """{entry point (mangled): (stack frame bytes, registers)} from
    ptxas's -v report of the build."""
    import re

    found, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            stack = None
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name is not None:
            stack = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            found[name] = (stack, int(m.group(1)))
            name = None
    return found


def encode_row(card: str, batch: int) -> dict:
    """The encode kernel on wifi1944 at ``batch``, the ``kernels`` line's
    row ``encode@wifi1944``: exactly the plain version, its time beside
    its bound (info bits read and codewords written once; one LOP3 a parity
    row and packed info word), the plain version's time, the float32
    ``torch.matmul`` of the plain version alone as ``library_ms`` (a
    yardstick: the port never calls it) and its launches in one
    ``mc_step``."""
    import importlib

    import torch

    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.ops import LinkConfig, phy
    from ldpc_sims_tpu_torch.parallel import mc_step

    enc = importlib.import_module("ldpc_sims_tpu_torch.ops.encode")
    code = get_code("wifi1944")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    u = phy.random_bits(gen, (batch, code.k))
    exact([(enc.encode(u, code), enc.encode_plain(u, code))], ENCODE_ROW)
    ms = cuda_time_ms(lambda: enc.encode(u, code), 50)
    plain_ms = cuda_time_ms(lambda: enc.encode_plain(u, code), 10)
    gt = torch.from_numpy(code.G.T.copy()).to("cuda", torch.float32)
    uf = u.to(torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms = cuda_time_ms(lambda: torch.matmul(uf, gt), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    step = mc_step(code, LinkConfig(bp_iterations=20, bp_method="min-sum",
                                    clamp=None), batch)
    step(1, 1.5)
    n0 = enc.ENCODE_LAUNCHES
    step(2, 1.5)
    launches = enc.ENCODE_LAUNCHES - n0
    if launches != 1:
        fail(f"{ENCODE_ROW}: {launches} encode launches in one mc_step")
    plan = enc.encode_plan(code)
    ops = len(plan.par_pos) * -(-code.k // 32) * batch
    t_bytes = batch * (code.k + code.n) / BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  {ENCODE_ROW} (encode_gf2): {ms!r} ms (plain {plain_ms!r} ms, "
          f"float32 product alone {library_ms!r} ms, bound {bound_ms!r} "
          f"ms, {bound_by}; bytes {t_bytes!r} ms, LOP3 {t_ops!r} ms), "
          f"{launches} launch an mc_step [{card}]", flush=True)
    return {
        "name": ENCODE_ROW,
        "entry": "encode_gf2",
        "route": "cuda",
        "source": ENCODE_SOURCE,
        "replaces": None,
        "launches": launches,
        "launches_per_mc_step": launches,
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def compare(kernel_out, plain_out, tag: str) -> float:
    """Hold a kernel posterior against the plain one; returns max |diff|."""
    import torch

    diff = (kernel_out - plain_out).abs()
    max_abs = float(diff.max())
    rel = diff / plain_out.abs().clamp_min(1e-30)
    bad = int((diff > TOL + TOL * plain_out.abs()).sum())
    sure = plain_out.abs() > HARD_MARGIN
    hard_bad = int(((kernel_out > 0) != (plain_out > 0))[sure].sum())
    print(f"  {tag}: max |diff| {max_abs:.3e}, max rel diff "
          f"{float(rel.max()):.3e}, out of tolerance {bad}, hard-bit "
          f"mismatches {hard_bad}", flush=True)
    if bad or hard_bad or not bool(torch.isfinite(kernel_out).all()):
        fail(f"kernel disagrees with its plain version: {tag}")
    return max_abs


def exact(pairs, tag: str) -> float:
    """Hold integer outputs (bits, counts) of a kernel against the plain
    version's: they must be equal. Returns max |diff| (0)."""
    import torch

    for got, want in pairs:
        if got.shape != want.shape or not torch.equal(got, want):
            n_bad = (int((got != want).sum()) if got.shape == want.shape
                     else "shape")
            fail(f"{tag}: differs from the plain version ({n_bad})")
    return 0.0


def channel_llrs(code, batch: int, snrdb: float, seed: int,
                 with_coded: bool = False):
    """LLRs of random codewords through the port's QPSK/OFDM-32 chain."""
    import torch

    from ldpc_sims_tpu_torch.ops import phy
    from ldpc_sims_tpu_torch.ops.encode import encode

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    coded = encode(phy.random_bits(gen, (batch, code.k)), code)
    tx = phy.ofdm_modulate(phy.modulate_qpsk(coded).reshape(batch // 8, -1),
                           32)
    snr = 10.0 ** (snrdb / 10.0)
    rx = phy.awgn(gen, tx, snr)
    sym = phy.ofdm_demodulate(rx)
    llr = phy.demodulate_qpsk_llr(sym, snr).reshape(batch, code.n)
    return (llr, coded) if with_coded else llr


def bler_within_4sigma(label: str, bler: float, frames: float, ref) -> None:
    """Fail unless ``bler`` over ``frames`` is within 4σ of the reference
    (BLER, frames): the binomial σ of the difference, pooled."""
    p_ref, n_ref = ref
    pool = (bler * frames + p_ref * n_ref) / (frames + n_ref)
    sigma = math.sqrt(pool * (1 - pool) * (1 / frames + 1 / n_ref))
    print(f"  {label}: BLER {bler!r} over {frames:g} frames against the JAX "
          f"curve's {p_ref!r} over {n_ref} (4σ = {4 * sigma!r})", flush=True)
    if abs(bler - p_ref) > 4 * sigma:
        fail(f"{label}: BLER {bler} is not within 4σ of {p_ref}")


def start_edge_probe():
    """Start building the probe kernels of :func:`edge_instruction_counts`
    from the decode source with its flags (the f32 translation unit): one
    ``nvcc`` in the background, ~45 s, so it overlaps phases 2-3. Returns
    the process and the cubin; the process is killed at exit if a phase
    fails before phase 4 waits for it."""
    import atexit

    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq

    mq.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = mq.BUILD_DIR / "edge_probe.cu"
    cubin = mq.BUILD_DIR / "edge_probe.cubin"
    src.write_text(f'#include "{mq.SOURCE}"\n' + EDGE_PROBE)
    flags = [f for f in mq.NVCC_FLAGS if f not in (
        "-Xptxas", "-v", "-Xcompiler", "-fPIC")]
    # the source's device functions alone, no entry point (QC_FAMILY=-1)
    proc = subprocess.Popen(
        [mq._nvcc(), *flags, "-DQC_STORAGE=0", "-DQC_FAMILY=-1", "-cubin",
         "-o", str(cubin), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, cubin


def edge_instruction_counts(probe) -> dict:
    """f32, MUFU and all instructions of the sum-product edge sequence
    (lt, the exclusive sum, the magnitude), of the message quantization
    and of the storage helpers' loads and stores (against ``probe_copy``,
    the same load and store with no conversion), from the SASS of the
    probe kernels :func:`start_edge_probe` builds; each function is
    counted up to its first EXIT, so the rare slow paths (the division's)
    are left out."""
    import re
    import shutil

    proc, cubin = probe
    _, err = proc.communicate(timeout=300)
    if proc.returncode:
        fail(f"the edge probe kernels did not build: {err[-2000:]}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True,
                          timeout=120).stdout
    counts, fn = {}, None
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"f32": 0, "mufu": 0, "all": 0, "open": True}
            continue
        m = op.search(line)
        if fn is None or m is None or not counts[fn]["open"]:
            continue
        base = m.group(1).split(".")[0]
        if base == "EXIT":
            counts[fn]["open"] = False
            continue
        counts[fn]["all"] += 1
        if base == "MUFU":
            counts[fn]["mufu"] += 1
        elif base.startswith("F") and base != "FLO":
            counts[fn]["f32"] += 1
    return {k: (v["f32"], v["mufu"], v["all"]) for k, v in counts.items()}


def smem_instructions(lib) -> tuple[dict, dict]:
    """The shared-memory instructions of the f32 decode kernels in the
    built library's SASS, serial-C and flooding: for min-sum's full-message
    designs (``minsum_qc_layered``, ``minsum_qc_flooding``, which the codes
    beyond the compressed state's limits keep) and the compressed ones
    (``minsum_qc_layered_cs``, ``minsum_qc_flooding_cs``), and for
    sum-product's full-message designs (``sumproduct_qc_layered``,
    ``sumproduct_qc_flooding``, the group-serial forms' and the codes'
    beyond the limits) and the ones with a check's slots in registers
    (``sumproduct_qc_layered_sr``, ``sumproduct_qc_flooding_sr``), and the
    group-serial kernels of both rules (``minsum_qc_layered_gs``,
    ``sumproduct_qc_layered_gs``), the min-sum kernels on the wide word
    (``minsum_qc_layered_cw``, ``minsum_qc_flooding_cw``) and sum-product
    flooding on the wide rows (``sumproduct_qc_flooding_lw``), each innermost
    loop (a backward branch that holds no other) as (instructions, LDS,
    STS, LDL + STL); and each kernel's SASS instructions in all."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    found, sizes = {}, {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        key = {"_Z17minsum_qc_layeredPKf": "serial-C full-message",
               "_Z20minsum_qc_layered_csPKf": "serial-C compressed",
               "_Z18minsum_qc_floodingPKf": "flooding full-message",
               "_Z21minsum_qc_flooding_csPKf": "flooding compressed",
               "_Z21sumproduct_qc_layeredPKf":
                   "sum-product serial-C full-message",
               "_Z24sumproduct_qc_layered_srPKf":
                   "sum-product serial-C registers",
               "_Z22sumproduct_qc_floodingPKf":
                   "sum-product flooding full-message",
               "_Z25sumproduct_qc_flooding_srPKf":
                   "sum-product flooding registers",
               "_Z20minsum_qc_layered_gsPKf": "group-serial compressed",
               "_Z20minsum_qc_layered_cwPKf": "serial-C compressed-wide",
               "_Z21minsum_qc_flooding_cwPKf": "flooding compressed-wide",
               "_Z24sumproduct_qc_layered_gsPKf":
                   "sum-product group-serial registers",
               "_Z25sumproduct_qc_flooding_lwPKf":
                   "sum-product flooding lt-wide"}.get(
                   name[:name.index("PKf") + 3] if "PKf" in name else "")
        if key is None:
            continue
        ins = []
        for line in block.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2).split(".")[0],
                            m.group(3)))
        # the kernel's code size
        sizes[key] = len(ins)
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        found[key] = sorted(
            (sum(1 for a, _, _ in ins if lo <= a <= hi),
             sum(1 for a, op, _ in ins if lo <= a <= hi and op == "LDS"),
             sum(1 for a, op, _ in ins if lo <= a <= hi and op == "STS"),
             sum(1 for a, op, _ in ins
                 if lo <= a <= hi and op in ("LDL", "STL")))
            for lo, hi in inner)
    return found, sizes


def plain_fixed(llr, qc, **kw):
    """One fixed decode of the plain version: its posterior, and the hard
    bits and unsatisfied-check counts its ``hard_unsat`` output derives
    from that posterior (``ops.bp_roll._emit``). The kernels' ``done_in``
    rows are held to the same posterior: the plain version decodes each
    codeword alone, so a row it skips leaves the others' values as they
    are."""
    import torch

    from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, unsat_checks

    post = decode_roll(llr, qc, output="posterior", **kw)
    internal = (-post).reshape(post.shape[0], qc.nb, qc.z)
    return post, ((post > 0).to(torch.int8), unsat_checks(internal, qc))


def adversarial(schedule, cases, storage_rows, max_err) -> None:
    """Integer LLRs in {-3, ..., 3}: tied minima, zero magnitudes and an
    offset above the minimum are common, the cases a compressed check state
    could get wrong. Every min-sum form of ``schedule`` (fixed with the
    unsatisfied-check count, early stop at K = 1 and 2, ``done_in``,
    weighted; with and without 3-bit messages) at each storage type (and,
    layered, at each group size, with both drivers), each exactly equal to
    the plain version (equal values: an int8 message that rounds to zero is +0
    in the kernels and may be -0 in the plain version, which no comparison
    or sum can tell apart). ``cases``: (code, group sizes) pairs; on a code
    within the compressed state's limits G = 1 runs the _cs kernels, G > 1
    the _gs kernels; on a code beyond them by its row degree alone G = 1
    (and flooding) the wide word's _cw kernels, G > 1 its _gw kernels; on
    a code with a row of a degree no wide body has, the full messages.
    Fails if a decode launches another design."""
    import torch

    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll

    B = 1024
    layered = schedule == "layered"
    for code, groups in cases:
        qc = code.qc
        gen = torch.Generator(device="cuda")
        gen.manual_seed(71)
        llr = torch.randint(-3, 4, (B, code.n), generator=gen,
                            device="cuda").float()
        skip = torch.arange(B, device="cuda") % 3 == 0
        w = random_edge_weights(code, 4, seed=72)
        rows = ("" if mq._within_limits(qc) else
                "-wide" if mq._within_limits(qc, wide=True) else None)
        for dt, sfx in {torch.float32: "f32", **storage_rows}.items():
            for G in groups:
                state = mq.entry_point(qc, "min-sum", schedule, dtype=dt,
                                       layered_group=G)
                want = "full" if rows is None else (
                    ("compressed" if G == 1 else "group") + rows)
                if mq.design(qc, "min-sum", schedule, G) != want:
                    fail(f"{code.name} {schedule} G={G}: launches {state}, "
                         f"not the {want} design")
                st = dict(schedule=schedule, dtype=dt, msg_qclip=4.0,
                          layered_group=G)
                for qb in (None, 3):
                    at = f"{code.name} {schedule} {sfx} G={G} msg_qbits={qb}"
                    kw = dict(st, msg_qbits=qb, iterations=4,
                              alpha=(1.0, 0.75, 0.5, 1.0),
                              beta=(0.0, 1.0, 2.5, 0.5), clamp=2.0)
                    p_post, p_hard = plain_fixed(llr, qc, **kw)
                    pairs = [(mq.bp_qc_cuda(llr, qc, output="posterior",
                                            **kw), p_post),
                             *zip(mq.bp_qc_cuda(llr, qc, output="hard_unsat",
                                                **kw), p_hard)]
                    name = mq.kernel_name("min-sum", schedule, False,
                                          qb is not None, dtype=dt)
                    max_err[name] = max(max_err[name],
                                        exact(pairs, f"{at} fixed"))
                    for K in (1, 2):
                        es = dict(kw, early_stop=True, es_check_every=K,
                                  output="hard_iters")
                        name = mq.kernel_name("min-sum", schedule, True,
                                              qb is not None, dtype=dt)
                        max_err[name] = max(max_err[name], exact(
                            list(zip(mq.bp_qc_cuda(llr, qc, **es),
                                     decode_roll(llr, qc, **es))),
                            f"{at} early stop K={K}"))
                    k = mq.bp_qc_cuda(llr, qc, output="posterior",
                                      done_in=skip, **kw)
                    exact([(k[~skip], p_post[~skip])], f"{at} done_in")
                    kw_w = dict(kw, weights=w, output="posterior")
                    name = mq.kernel_name("min-sum", schedule, False,
                                          qb is not None, True, dt)
                    max_err[name] = max(max_err[name], exact(
                        [(mq.bp_qc_cuda(llr, qc, **kw_w),
                          decode_roll(llr, qc, **kw_w))], f"{at} weighted"))
                if not layered:
                    print(f"  {code.name} flooding {sfx} ({state}): fixed, "
                          "unsatisfied counts, early stop, done_in, weighted "
                          "(each with and without 3-bit messages) equal",
                          flush=True)
                    continue
                # both drivers, against plain compositions of their passes
                rb, ri = mq.bp_qc_requeue(llr, qc, 4, probe_iters=2,
                                          es_check_every=1,
                                          output="hard_iters", **st)
                es = dict(st, early_stop=True, output="hard_iters")
                b1, i1 = decode_roll(llr, qc, iterations=2, **es)
                b2, i2 = decode_roll(llr, qc, iterations=4, **es)
                done = i1 < 2
                exact([(rb, torch.where(done[:, None], b1, b2)),
                       (ri, torch.where(done, i1, 2 + i2))],
                      f"{code.name} {sfx} G={G} bp_qc_requeue")
                pb_, pi_ = mq.bp_qc_probe_requeue(
                    llr, qc, 4, probe_iters=2, output="hard_iters", **st)
                b1, u1 = decode_roll(llr, qc, iterations=2,
                                     output="hard_unsat", **st)
                b2 = decode_roll(llr, qc, iterations=4, **st)
                keep = (u1 == 0) & (B - int((u1 == 0).sum())
                                    <= mq.probe_capacity(B))
                exact([(pb_, torch.where(keep[:, None], b1, b2)),
                       (pi_, torch.where(keep, 2, 6).to(torch.int32))],
                      f"{code.name} {sfx} G={G} bp_qc_probe_requeue")
                print(f"  {code.name} {sfx} G={G} ({state}): fixed, "
                      "unsatisfied counts, early stop, done_in, weighted "
                      "(each with and without 3-bit messages) and both "
                      "drivers equal", flush=True)


def sumproduct_registers(cases, storage_rows, max_err) -> None:
    """Every sum-product form (fixed with its unsatisfied-check count, early
    stop at K = 1 and 2, ``done_in``, weighted; with and without 4-bit
    messages; both schedules, layered alone for G > 1) and both drivers at
    f32, bf16 and int8 on channel LLRs with 64 rows saturated at |LLR| =
    60, each exactly equal to the plain version, for each (code, group,
    entry point suffix) of ``cases``: ``_sr`` (a check's slots in
    registers), ``_gs`` (group-serial), their forms on the wide rows
    ``_rw`` (serial-C), ``_lw`` (flooding) and ``_gw``, or ``""`` (the
    full-message kernels a code with a row of a degree no wide body has
    keeps), or a dict of them by schedule (the schedules it names alone;
    the drivers where it names layered). Batch 1024, 4 iterations (the
    drivers 2 + 4): the plain version on the card is most of the time."""
    import torch

    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll

    for code, G, want in cases:
        qc = code.qc
        B = 1024
        llr = channel_llrs(code, B, 1.5, seed=81)
        llr[:64] = torch.where(llr[:64] > 0, 60.0, -60.0)
        skip = torch.arange(B, device="cuda") % 3 == 0
        w = random_edge_weights(code, 4, seed=82)
        wants = want if isinstance(want, dict) else dict.fromkeys(
            ("flooding", "layered") if G == 1 else ("layered",), want)
        for dt, sfx in {torch.float32: "f32", **storage_rows}.items():
            for sched in wants:
                st = dict(schedule=sched, method="sum-product", dtype=dt,
                          msg_qclip=20.0, layered_group=G)
                entry = mq.entry_point(qc, "sum-product", sched, dtype=dt,
                                       layered_group=G)
                if entry != mq.kernel_name("sum-product", sched) + \
                        wants[sched] + mq.STORAGE[dt][1]:
                    fail(f"{code.name} G={G} {sched}: launches {entry}")
                for qb in (None, 4):
                    at = f"{code.name} {sched} {sfx} G={G} msg_qbits={qb}"
                    kw = dict(st, msg_qbits=qb, iterations=4)
                    p_post, p_hard = plain_fixed(llr, qc, **kw)
                    pairs = [(mq.bp_qc_cuda(llr, qc, output="posterior",
                                            **kw), p_post),
                             *zip(mq.bp_qc_cuda(llr, qc, output="hard_unsat",
                                                **kw), p_hard)]
                    name = mq.kernel_name("sum-product", sched, False,
                                          qb is not None, dtype=dt)
                    max_err[name] = max(max_err[name],
                                        exact(pairs, f"{at} fixed"))
                    for K in (1, 2):
                        es = dict(kw, early_stop=True, es_check_every=K,
                                  output="hard_iters")
                        name = mq.kernel_name("sum-product", sched, True,
                                              qb is not None, dtype=dt)
                        max_err[name] = max(max_err[name], exact(
                            list(zip(mq.bp_qc_cuda(llr, qc, **es),
                                     decode_roll(llr, qc, **es))),
                            f"{at} early stop K={K}"))
                    k = mq.bp_qc_cuda(llr, qc, output="posterior",
                                      done_in=skip, **kw)
                    exact([(k[~skip], p_post[~skip])], f"{at} done_in")
                    kw_w = dict(kw, iterations=4, weights=w,
                                output="posterior")
                    name = mq.kernel_name("sum-product", sched, False,
                                          qb is not None, True, dt)
                    max_err[name] = max(max_err[name], exact(
                        [(mq.bp_qc_cuda(llr, qc, **kw_w),
                          decode_roll(llr, qc, **kw_w))], f"{at} weighted"))
                print(f"  {code.name} {sched} {sfx} G={G} ({entry}): fixed, "
                      "unsatisfied counts, early stop K = 1, 2, done_in, "
                      "weighted (each with and without 4-bit messages) "
                      "equal", flush=True)
            if "layered" not in wants:
                continue
            # both drivers, against plain compositions of their passes
            st = dict(schedule="layered", method="sum-product", dtype=dt,
                      msg_qclip=20.0, layered_group=G)
            rb, ri = mq.bp_qc_requeue(llr, qc, 4, probe_iters=2,
                                      es_check_every=2, output="hard_iters",
                                      **st)
            es = dict(st, early_stop=True, es_check_every=2,
                      output="hard_iters")
            b1, i1 = decode_roll(llr, qc, iterations=2, **es)
            b2, i2 = decode_roll(llr, qc, iterations=4, **es)
            done = i1 < 2
            exact([(rb, torch.where(done[:, None], b1, b2)),
                   (ri, torch.where(done, i1, 2 + i2))],
                  f"{code.name} {sfx} G={G} sum-product bp_qc_requeue")
            pb_, pi_ = mq.bp_qc_probe_requeue(llr, qc, 4, probe_iters=2,
                                              output="hard_iters", **st)
            b1, u1 = decode_roll(llr, qc, iterations=2, output="hard_unsat",
                                 **st)
            b2 = decode_roll(llr, qc, iterations=4, **st)
            keep = (u1 == 0) & (B - int((u1 == 0).sum())
                                <= mq.probe_capacity(B))
            exact([(pb_, torch.where(keep[:, None], b1, b2)),
                   (pi_, torch.where(keep, 2, 6).to(torch.int32))],
                  f"{code.name} {sfx} G={G} sum-product bp_qc_probe_requeue")
            print(f"  {code.name} {sfx} G={G}: sum-product drivers equal",
                  flush=True)


def lw_kwargs(form: str, dsfx: str, weights) -> dict:
    """The decode of an LW_ROWS row: sum-product flooding-20 (flooding-12
    with ``weights``) in its form, at its storage type (bf16 and int8 on
    the ±24 grid)."""
    import torch

    kw = dict(iterations=20, method="sum-product", schedule="flooding",
              dtype=getattr(torch, LW_STORAGE[dsfx]))
    kw.update({k: v for k, v in LW_FORMS[form].items() if k != "weights"})
    if LW_FORMS[form].get("weights"):
        kw.update(iterations=12, weights=weights)
    if dsfx:
        kw["msg_qclip"] = 24.0
    return kw


def lw_entry(code, kw: dict) -> str:
    """The entry point a decode of ``lw_kwargs`` launches."""
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq

    return mq.entry_point(code.qc, "sum-product", "flooding",
                          kw.get("early_stop", False),
                          kw.get("msg_qbits") is not None, "weights" in kw,
                          kw["dtype"])


def degree10_code():
    """qc1944_r34's base (z = 81) with the circulant of its second block
    row's first column dropped: a row of degree 10 beside rows of 11 and
    12, a degree no body of the wide rows has, so every form decodes on the
    full-message kernels. Its checks decode channel or integer LLRs: no
    encoder is needed."""
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.codes.qc_construct import qc_from_base

    base = [list(r) for r in get_code("qc1944_r34").qc.base]
    if sum(s >= 0 for s in base[1]) != 11 or base[1][0] < 0:
        fail("qc1944_r34's second block row is not the degree-11 row")
    base[1][0] = -1
    return qc_from_base(base, 81, "qc1944_r34_d10")


def external_unsat(bits, code):
    """Unsatisfied checks per row as bits·Hᵀ mod 2, summed."""
    import numpy as np
    import torch

    H = torch.from_numpy(np.asarray(code.H, np.float32)).to(bits.device)
    return torch.remainder(bits.float() @ H.T, 2.0).sum(1).to(torch.int32)


def edge_ops(schedule: str, iterations: int, alpha=1.0, beta=0.0,
             clamp=None) -> int:
    """f32 operations per edge over ``iterations`` iterations with these
    parameters: an iteration whose β is not 0 adds the offset and its max
    with 0 (2), an α other than 1 its multiply (1), a clamp its two
    bounds (2)."""
    def table(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v,) * iterations

    al, be = table(alpha), table(beta)
    per = OPS_PER_EDGE_ITER[schedule] + (2 if clamp is not None else 0)
    return sum(per + (a != 1.0) + 2 * (b != 0.0) for a, b in zip(al, be))


def weighted_ops(schedule: str, iterations: int, E: int, n: int,
                 alpha=1.0, beta=0.0) -> int:
    """f32 operations of one weighted decode: the unweighted count, plus
    per edge and iteration the weight's multiply in the v2c and in the
    posterior (flooding) or in the v2c, the message change and the
    re-base's multiply and add (layered), plus per variable the LLR
    weight's multiply in each posterior build. The first build is over
    zero messages, so it needs only those LLR multiplies."""
    extra = 2 if schedule == "flooding" else 4
    return (E * (edge_ops(schedule, iterations, alpha, beta)
                 + extra * iterations) + n * (iterations + 1))


def random_edge_weights(code, iterations: int, seed: int) -> dict:
    """Edge-flavor weights drawn uniformly from [0.7, 1.3] (NumPy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = code.graph
    shapes = {"w_msg": (iterations, g.n_vars, g.dv),
              "w_llr": (iterations, g.n_vars),
              "w_msg_final": (g.n_vars, g.dv), "w_llr_final": (g.n_vars,)}
    return {k: rng.uniform(0.7, 1.3, s).astype(np.float32)
            for k, s in shapes.items()}


def artifact_ber(code, snrdb: float, batches: int, batch: int, seed: int,
                 **kw):
    """Coded BER and frames in error on the K6 artifact's own channel
    (examples/train_edge_layered_1944.py:175-179): all-zero codewords,
    BPSK r = 1 + σ·n with σ = snr^-½, llr = −2r/σ², every bit counted."""
    import torch

    from ldpc_sims_tpu_torch.kernels.compare import floor_llrs
    from ldpc_sims_tpu_torch.ops import bp_decode

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    errs = frames = 0
    for _ in range(batches):
        bits = bp_decode(floor_llrs(code, batch, snrdb, gen), code, **kw)
        errs += int(bits.sum(dtype=torch.int64))
        frames += int(bits.any(dim=1).sum())
    return errs / (batches * batch * code.n), frames


def info_ber(code, snrdb: float, batches: int, batch: int, seed: int,
             **kw):
    """Info-bit BER and its standard error on the flooding artifact's
    channel (examples/train_minsum_1944.py:63-114): all-zero codewords,
    BPSK r = 1 + σ·n with σ = snr^-½, llr = −2r/σ², the first k bits of
    each codeword counted; the error from the per-codeword counts."""
    import torch

    from ldpc_sims_tpu_torch.kernels.compare import floor_llrs
    from ldpc_sims_tpu_torch.ops import bp_decode

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    errs = []
    for _ in range(batches):
        bits = bp_decode(floor_llrs(code, batch, snrdb, gen), code, **kw)
        errs.append(bits[:, :code.k].sum(1, dtype=torch.int64))
    e = torch.cat(errs).double()
    return (float(e.mean()) / code.k,
            float(e.std()) / (e.numel() ** 0.5 * code.k))


def uncoded_ber(modulation: str, snrdb: float) -> float:
    """Uncoded BER of BPSK, Gray QPSK or 16-QAM at symbol SNR ``snrdb``."""
    q = lambda x: 0.5 * math.erfc(x / math.sqrt(2))  # noqa: E731
    snr = 10 ** (snrdb / 10)
    if modulation == "bpsk":  # amplitude 1, sigma^2 = 1/(2 snr)
        return q(math.sqrt(2 * snr))
    if modulation == "qpsk":  # amplitude 1/sqrt2, sigma^2 = 1/(2 snr)
        return q(math.sqrt(snr))
    # 16-QAM, per axis levels ±1, ±3 over sqrt10: x = d / sigma
    x = math.sqrt(snr / 5)
    return (3 * q(x) + 2 * q(3 * x) - q(5 * x)) / 4


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_step(step, label: str, card: str, snrdb: float = 1.5,
                 what: str | None = None) -> float:
    """Device time by kernel over one steady ``step(seed, snrdb)``, an
    mc_step unless ``what`` names another (torch.profiler); returns the
    step's wall in µs."""
    what = what or f"mc_step at {snrdb:g} dB"
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(1, snrdb)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(2, snrdb)
        torch.stack(list(out.values())).tolist()  # the step's host read
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a host-side operator
        # reports its kernels' time again as its own device time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.key, e.count))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"  {label} profile: device time not measured by "
              "torch.profiler", flush=True)
        return wall_us
    rows.sort(reverse=True)
    print(f"  {label} profile of one {what} [{card}]: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / wall_us:.3f}", flush=True)
    for us, key, n in rows[:8]:
        print(f"    {us / 1e3:9.3f} ms {us / busy:6.1%}  x{n}  {key[:70]}",
              flush=True)
    return wall_us


class Events:
    """A ``metrics`` sink for run_sweep: keeps the step and es-auto events."""

    def __init__(self):
        self.steps = []
        self.auto = []

    def log(self, event, **fields):
        if event == "sweep-step":
            self.steps.append(fields)
        elif event == "es-auto":
            self.auto.append(fields)


def drive(label, code, cfg, sweep, need, card, coded_below=True,
          weights=None):
    """One main-path run: counters to 0, run_sweep, counters read.

    Fails unless every kernel in ``need`` was launched; checks the rates
    (with ``coded_below``, coded BER below uncoded). Returns (result,
    launch counts, events, steady info bits/s); ``events.mc_steps``
    counts the run's mc_steps, ``events.entries`` the launches per CUDA
    entry point."""
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.parallel import run_sweep

    ev = Events()
    mq.reset_launch_counts()
    res = run_sweep(code, cfg, sweep, weights=weights, log=None, metrics=ev,
                    device="cuda")
    counts = dict(mq.LAUNCHES)
    ev.entries = dict(mq.ENTRY_LAUNCHES)
    n_steps = ev.mc_steps = len(ev.steps) * sweep.steps_per_sync
    for name in need:
        if counts[name] == 0:
            fail(f"{label}: the main path never launched {name}")
    modes = {}
    for e in ev.steps:
        modes[e["mode"]] = modes.get(e["mode"], 0) + 1
    per = {k: v / n_steps for k, v in counts.items() if v}
    launched = {k: v for k, v in counts.items() if v}
    print(f"  {label}: launches {launched} over {n_steps} mc_steps "
          f"(per mc_step {per}; mc_steps per mode {modes}; entry points "
          f"{ev.entries})", flush=True)
    for a in ev.auto:
        print(f"  {label} calibration @ {a['snrdb']:g} dB: fixed "
              f"{a['fixed'] * 1e3!r} ms, probe {a['probe'] * 1e3!r} ms "
              f"-> {a['mode']} [{card}]", flush=True)
    steady = ev.steps[1:]  # the first step pays one-time set-up
    rate = (sum(e["info_bits"] for e in steady)
            / sum(e["wall_s"] for e in steady))
    for snr, unc, ber, bler, bits in zip(
            res.snrdb, res.uncoded_ber, res.coded_ber, res.coded_bler,
            res.info_bits):
        print(f"  {label} @ {snr:g} dB: uncoded BER {unc!r}, coded BER "
              f"{ber!r}, BLER {bler!r} ({bits:.4g} info bits) [{card}]",
              flush=True)
        theory = uncoded_ber(cfg.modulation, snr)
        if not all(math.isfinite(v) for v in (unc, ber, bler)):
            fail(f"{label} @ {snr:g} dB: non-finite rates")
        if abs(unc - theory) > 1e-3:
            fail(f"{label} @ {snr:g} dB: uncoded BER {unc} is not the "
                 f"{cfg.modulation} value {theory}")
        if coded_below and not ber < unc:
            fail(f"{label} @ {snr:g} dB: coded BER {ber} not below "
                 f"uncoded {unc}")
    print(f"  {label}: steady-state {rate!r} decoded info bits/s over "
          f"{len(steady)} chunks of {sweep.steps_per_sync} mc_steps "
          f"[{card}]", flush=True)
    return res, counts, ev, rate


def hold_posteriors(label: str, got, want, per_mille: int = 0) -> None:
    """Hold one backend's posteriors (batch, n) against another's on
    all-zero codewords: hard bits equal wherever |want| > HARD_MARGIN,
    the frame errors equal, and within GATHER_RTOL relative + GATHER_ATOL
    absolute in every codeword both decode but ``per_mille`` in a thousand
    of them (min-sum amplifies last-bit differences in codewords that do
    not converge, and in a long code also in some that converge late)."""
    import torch

    sure = want.abs() > HARD_MARGIN
    hard_bad = int(((got > 0) != (want > 0))[sure].sum())
    fe_got, fe_want = (got > 0).any(1), (want > 0).any(1)
    out = ((got - want).abs()
           > GATHER_ATOL + GATHER_RTOL * want.abs()).any(1)
    bad = int((out & ~fe_got & ~fe_want).sum())
    print(f"  {label}: max |diff| {float((got - want).abs().max())!r}, "
          f"hard-bit mismatches {hard_bad}, frame errors {int(fe_got.sum())}"
          f" / {int(fe_want.sum())} of {got.shape[0]}, codewords out of "
          f"tolerance {bad} decoded + {int((out & fe_want).sum())} in "
          "frame error", flush=True)
    decoded = int((~fe_got & ~fe_want).sum())
    if (hard_bad or bad > per_mille * decoded / 1000
            or not torch.equal(fe_got, fe_want)):
        fail(f"{label}: differs")


def tf32_engaged() -> None:
    """Fail unless TF32 is on: a float32 product of random matrices must
    then differ from the same product in float64 by more than float32's
    rounding does."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    a = torch.randn((512, 512), generator=gen, device="cuda")
    err = float(((a @ a).double() - a.double() @ a.double()).abs().max())
    if err < 1e-3:
        fail(f"TF32 did not engage (max |diff| {err})")


def dense_vs_gather(code, batch: int, card: str, per_mille: int = 0,
                    **kw) -> None:
    """bp_decode(backend='dense') beside backend='gather' on the BPSK
    channel of all-zero codewords at 2.0 dB: posteriors (within the
    tolerance in all decoded codewords but ``per_mille`` in a thousand)
    with TF32 off and on, early-stop freeze bits and iterations, ms per
    decode."""
    import torch

    from ldpc_sims_tpu_torch.kernels.compare import floor_llrs
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.ops import bp_decode

    label = f"{code.name} {kw['method']}-{kw['iterations']}"
    llr = floor_llrs(code, batch, 2.0, 31)
    mq.reset_launch_counts()
    post = {b: bp_decode(llr, code, backend=b, output="posterior", **kw)
            for b in ("dense", "gather")}
    hold_posteriors(f"{label} dense against gather (batch {batch})",
                    post["dense"], post["gather"], per_mille)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_engaged()
        on = bp_decode(llr, code, backend="dense", output="posterior", **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"  {label} dense with TF32 on: posteriors equal to TF32 off: "
          f"{torch.equal(on, post['dense'])}", flush=True)
    if not torch.equal(on, post["dense"]):
        fail(f"{label}: the dense decode changed with TF32 on")
    # early stop: a codeword that stops before the budget must stop at the
    # same iteration with the same bits; one that runs the budget ran the
    # fixed decode, so its bits must be that decode's (held above)
    es = {b: bp_decode(llr, code, backend=b, output="hard_iters",
                       early_stop=True, **kw) for b in ("dense", "gather")}
    (db, di), (gb, gi) = es["dense"], es["gather"]
    stopped = gi < kw["iterations"]
    own = all(torch.equal(es[b][0][~stopped],
                          (post[b][~stopped] > 0).to(torch.int8))
              for b in es)
    print(f"  {label} early stop: iterations equal {torch.equal(di, gi)}, "
          f"bits equal in the {int(stopped.sum())} codewords that stopped "
          f"{torch.equal(db[stopped], gb[stopped])}, the others' bits their "
          f"fixed decode's {own}, bits equal everywhere "
          f"{torch.equal(db, gb)}, mean iterations "
          f"{float(gi.float().mean())!r}", flush=True)
    if not (torch.equal(di, gi) and torch.equal(db[stopped], gb[stopped])
            and own):
        fail(f"{label}: the dense early stop differs from gather's")
    if any(mq.LAUNCHES.values()):
        fail(f"{label}: a non-QC decode launched {dict(mq.LAUNCHES)}")
    ms = {b: cuda_time_ms(lambda b=b: bp_decode(llr, code, backend=b, **kw),
                          reps=3, warmup=1) for b in ("dense", "gather")}
    print(f"  {label} at batch {batch}: dense {ms['dense']!r} ms, gather "
          f"{ms['gather']!r} ms a decode [{card}]", flush=True)


def pair_weights(code, qc_code, card: str) -> None:
    """Pair-flavor weights: random ones decode on the gather backend under
    auto; the identity decodes as the unweighted; on a QC code auto still
    goes to gather and launches no kernel."""
    import numpy as np
    import torch

    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.kernels.compare import floor_llrs
    from ldpc_sims_tpu_torch.ops import bp_decode, init_neural_bp_weights

    kw = dict(iterations=10, method="min-sum", output="posterior")
    llr = floor_llrs(code, 32768, 2.0, 33)
    ident = init_neural_bp_weights(code, 10, flavor="pair")
    rng = np.random.default_rng(34)
    rand = {k: rng.uniform(0.7, 1.3, tuple(v.shape)).astype(np.float32)
            for k, v in ident.items()}
    got = bp_decode(llr, code, weights=rand, **kw)
    want = bp_decode(llr, code, weights=rand, backend="gather", **kw)
    if not (torch.equal(got, want) and bool(torch.isfinite(got).all())):
        fail("random pair weights: auto differs from backend='gather'")
    print(f"  {code.name} random pair weights in [0.7, 1.3]: auto equal to "
          "gather, finite", flush=True)
    hold_posteriors(f"{code.name} identity pair weights against unweighted",
                    bp_decode(llr, code, weights=ident, **kw),
                    bp_decode(llr, code, **kw))
    mq.reset_launch_counts()
    qllr = floor_llrs(qc_code, 256, 2.0, 35)
    qw = init_neural_bp_weights(qc_code, 2, flavor="pair")
    post = bp_decode(qllr, qc_code, iterations=2, weights=qw,
                     output="posterior")
    ref = bp_decode(qllr, qc_code, iterations=2, weights=qw,
                    backend="gather", output="posterior")
    if any(mq.LAUNCHES.values()) or not torch.equal(post, ref):
        fail(f"{qc_code.name} pair weights: auto did not take the gather "
             f"backend (launches {dict(mq.LAUNCHES)})")
    print(f"  {qc_code.name} pair weights: auto took the gather backend, no "
          f"kernel launched [{card}]", flush=True)


def sweep_outputs(card: str) -> None:
    """One short ``python -m ldpc_sims_tpu_torch sweep --profile``: its
    metrics, registry record and Chrome trace."""
    import tempfile

    from ldpc_sims_tpu_torch.cli.main import main as cli_main
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq

    with tempfile.TemporaryDirectory() as out:
        mq.reset_launch_counts()
        # batch x k = 31.85M info bits a step: 2 steps reach --max-bits
        cli_main(["sweep", "--code", "wifi1944", "--method", "min-sum",
                  "--iters", "20", "--clamp", "0", "--batch", "32768",
                  "--snr", "1.5", "--max-bits", "4e7", "--target-errors",
                  str(10**9), "--profile", "--out", out])
        launched = dict(mq.ENTRY_LAUNCHES)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        with open(os.path.join(out, "registry.jsonl")) as f:
            runs = [json.loads(line) for line in f]
        trace, = [d for d in os.listdir(out) if d.endswith("_trace")]
        with open(os.path.join(out, trace, "trace.json")) as f:
            trace_events = json.load(f)["traceEvents"]
    names = [e["event"] for e in events]
    print(f"  sweep --profile: launched {launched}; metrics events {names}; "
          f"phases {events[-1]}; registry {runs}", flush=True)
    if names != ["sweep-step", "sweep-step", "sweep-point", "sweep-phases"]:
        fail(f"sweep --profile: metrics.jsonl holds {names}")
    if "compile+first-step" not in events[-1]:
        fail(f"sweep --profile: phases {events[-1]}")
    if len(runs) != 1 or runs[0]["kind"] != "sweep":
        fail(f"sweep --profile: registry.jsonl holds {runs}")
    if launched != {"minsum_qc_flooding_cs": 2}:
        fail(f"sweep --profile: launched {launched}")
    kernels = {}
    for e in trace_events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + e.get("dur", 0)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    total = sum(kernels.values())
    print(f"  trace: {len(trace_events)} events, {len(kernels)} kernels, "
          f"kernel time {total / 1e3:.3f} ms [{card}]", flush=True)
    for name, us in top:
        print(f"    {us / 1e3:9.3f} ms {us / total:6.1%}  {name[:70]}",
              flush=True)
    if not any("minsum_qc_flooding_cs" in k for k in kernels):
        fail("sweep --profile: the trace names no minsum_qc_flooding_cs")


def evaluate_phase(card: str, name: str, batch: int) -> dict:
    """Phase 3h: ``evaluate`` as a user runs it (a JAX-format checkpoint of
    a seeded estimator), its curves against ``run_sweep``'s, the NN
    forward card against CPU, the checkpoint round trip, ``sweep
    --multihost`` on one NCCL rank against ``sweep``, ``scaling-probe``
    and ``run_grid``. Returns the evaluate run's flooding launches and
    one point's three LLR sets (for the kernels line)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_3h_") as tmp:
        return _evaluate_phase(card, name, batch, tmp)


def _evaluate_phase(card: str, name: str, batch: int, tmp: str) -> dict:
    import numpy as np
    import torch

    from ldpc_sims_tpu_torch.cli.main import main as cli_main
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.convert import llr_params_to_flax
    from ldpc_sims_tpu_torch.evaluate import invert_tanh
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.models import LLRestimator, LLRestimatorTanh
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step
    from ldpc_sims_tpu_torch.parallel import (
        SweepConfig,
        mc_step,
        run_grid,
        run_sweep,
    )
    from ldpc_sims_tpu_torch.parallel.mc import stable_seed
    from ldpc_sims_tpu_torch.utils import load_checkpoint, save_checkpoint

    code = get_code(name)
    snrs = (1.5, 2.0)
    f20 = LinkConfig(bp_iterations=20, bp_method="min-sum", clamp=None)
    flags = ["--code", name, "--method", "min-sum", "--iters", "20",
             "--clamp", "0", "--batch", str(batch)]
    model = LLRestimator(32, generator=torch.Generator().manual_seed(5))

    # the checkpoint round trip on this machine (no flax, no msgpack here)
    t0 = time.perf_counter()
    tree = {"params": llr_params_to_flax(model), "opt_state": None,
            "extra": {"bf16": torch.arange(8, dtype=torch.bfloat16) / 7,
                      "step": np.int64(3)}}
    ckpt = save_checkpoint(os.path.join(tmp, "llr"), tree,
                           {"model": "LLRestimator", "seed": 5})
    back, mani = load_checkpoint(ckpt)
    same = mani == {"model": "LLRestimator", "seed": 5} and back[
        "opt_state"] is None and int(back["extra"]["step"]) == 3 and \
        torch.equal(back["extra"]["bf16"], tree["extra"]["bf16"])
    for layer, leaves in tree["params"]["params"].items():
        for kind, a in leaves.items():
            got = back["params"]["params"][layer][kind]
            same &= got.dtype == a.dtype and np.array_equal(got, a)
    nbytes = os.path.getsize(os.path.join(ckpt, "params.msgpack"))
    print(f"  checkpoint round trip: {nbytes} B of params.msgpack written "
          f"and read back equal: {same} ({time.perf_counter() - t0:.3f} s)",
          flush=True)
    if not same:
        fail("the checkpoint read back differs from what was written")

    # evaluate as a user runs it
    out = os.path.join(tmp, "eval")
    mq.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["evaluate", *flags, "--qbits", "3", "--snr",
              ",".join(f"{x:g}" for x in snrs), "--ckpt", ckpt,
              "--out", out])
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in mq.LAUNCHES.items() if v}
    entries = dict(mq.ENTRY_LAUNCHES)
    (path,) = [f for f in os.listdir(out) if f.endswith("_eval.json")]
    with open(os.path.join(out, path)) as f:
        curves = json.load(f)
    print(f"  evaluate ({code.name}, QPSK/OFDM-32, min-sum flooding-20, "
          f"3-bit ADC, global AGC, batch {batch}, LLRestimator): "
          f"{wall:.3f} s for {len(snrs)} points, {wall / len(snrs):.3f} s "
          f"a point (first use included); launches {launched}, entry "
          f"points {entries} [{card}]", flush=True)
    print(f"  evaluate curves: {json.dumps(curves)}", flush=True)
    if launched != {"minsum_qc_flooding": 3 * len(snrs)}:
        fail(f"evaluate launched {launched}, not minsum_qc_flooding three "
             "times a point")
    for k, v in curves.items():
        if k != "code" and not all(math.isfinite(x) for x in v):
            fail(f"evaluate: non-finite {k}")
    with open(os.path.join(out, "registry.jsonl")) as f:
        runs = [json.loads(line) for line in f]
    if [r["kind"] for r in runs] != ["evaluate"] or runs[0]["ckpt"] != ckpt:
        fail(f"evaluate: registry holds {runs}")

    # its Traditional and Quantized curves against run_sweep's
    steps = 4
    sweep = SweepConfig(snrdb=snrs, batch_cw=batch,
                        target_frame_errors=10**12,
                        max_info_bits=steps * batch * code.k, seed=3)
    for tag, cfg in (("", f20),
                     ("_qllr", dataclasses.replace(f20, qbits=3))):
        res = run_sweep(code, cfg, sweep, log=None, device="cuda")
        for i, snr in enumerate(snrs):
            n_e, n_s = batch, res.frames[i]
            be, bs = curves["coded_bler" + tag][i], res.coded_bler[i]
            ee, es = curves["coded_ber" + tag][i], res.coded_ber[i]
            p = (be * n_e + bs * n_s) / (n_e + n_s)
            s_bler = math.sqrt(p * (1 - p) * (1 / n_e + 1 / n_s))
            # a frame's info-bit error fraction x is at most 1, so its
            # variance is at most its mean: σ of the BER from the frames
            q = (ee * n_e + es * n_s) / (n_e + n_s)
            s_ber = math.sqrt(q * (1 / n_e + 1 / n_s))
            name = "Traditional" if not tag else "Quantized"
            print(f"  {name} @ {snr:g} dB: evaluate BER {ee!r} BLER {be!r} "
                  f"({n_e} frames), run_sweep BER {es!r} BLER {bs!r} "
                  f"({n_s:g} frames); 4σ {4 * s_ber!r}, {4 * s_bler!r} "
                  f"[{card}]", flush=True)
            if abs(be - bs) > 4 * s_bler or abs(ee - es) > 4 * s_ber:
                fail(f"evaluate {name} @ {snr:g} dB is not within 4σ of "
                     "run_sweep's")

    # the NN forward, card against CPU, and its time at full size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    arrays = link_step(gen, snrs[0], code, dataclasses.replace(f20, qbits=3),
                       batch, return_arrays=True)
    sig = arrays["q_time"].reshape(-1, 32)
    x = torch.cat([sig.real, sig.imag], dim=1)
    xs = torch.cat([x, arrays["snr_sym"].reshape(-1, 1)], dim=1)
    tanh_model = LLRestimatorTanh(
        32, generator=torch.Generator().manual_seed(6))
    for label, m, inp, post in (("LLRestimator", model, x, None),
                                ("LLRestimatorTanh", tanh_model, xs,
                                 invert_tanh)):
        rows = inp[:4096]
        with torch.no_grad():
            on_card = m.to("cuda")(rows)
            on_cpu = m.to("cpu")(rows.cpu())
        if post is not None:
            on_card, on_cpu = post(on_card), post(on_cpu)
        diff = float((on_card.cpu() - on_cpu).abs().max())
        top = float(on_cpu.abs().max())
        print(f"  {label} forward on 4096 rows, card against CPU: max |diff| "
              f"{diff!r}, max |LLR| {top!r} (limit 1e-4 x max |LLR|) "
              f"[{card}]", flush=True)
        if not diff <= 1e-4 * top or not math.isfinite(top):
            fail(f"{label}: the card's forward differs from the CPU's")
    model.to("cuda")
    with torch.no_grad():
        ms = cuda_time_ms(lambda: model(x), 5)
    flops = x.shape[0] * NN_OPS_PER_ROW
    print(f"  LLRestimator forward on {x.shape[0]} rows (one evaluate "
          f"point at batch {batch}): {ms!r} ms, {flops / ms / 1e9:.1f} "
          f"TFLOP/s, bound {flops / F32_FMA_OPS_PER_S * 1e3!r} ms (f32, "
          f"TF32 {torch.backends.cuda.matmul.allow_tf32}) [{card}]",
          flush=True)
    with torch.no_grad():
        nn = model(x).reshape(-1, code.n)
    eval_llrs = {"trad": arrays["llrs"], "quant": arrays["qllrs"],
                 "nn": nn}

    # sweep --multihost on one NCCL rank equals sweep, count for count
    grid = ["--snr", ",".join(f"{x:g}" for x in snrs), "--max-bits",
            str(2 * batch * code.k), "--target-errors", str(10**12)]
    outs = {}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "ldpc_sims_tpu_torch", "sweep",
         "--multihost", *flags, *grid, "--out",
         os.path.join(tmp, "multihost")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    t_mh = time.perf_counter() - t0
    backend = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("distributed:")]
    print(f"  sweep --multihost (torch.distributed.run, 1 rank): rc "
          f"{proc.returncode}, {t_mh:.1f} s; {backend}", flush=True)
    if proc.returncode != 0 or not backend or "nccl" not in backend[0]:
        fail(f"sweep --multihost: {proc.stdout[-2000:]}"
             f"{proc.stderr[-2000:]}")
    cli_main(["sweep", *flags, *grid, "--out", os.path.join(tmp, "plain")])
    for tag in ("multihost", "plain"):
        d = os.path.join(tmp, tag)
        (m,) = [f for f in os.listdir(d) if f.endswith("_sweep.json")]
        with open(os.path.join(d, m)) as f:
            pts = json.load(f)["points"]
        outs[tag] = {p: {k: v for k, v in c.items()
                         if k not in ("wall_s",)} for p, c in pts.items()}
    print(f"  sweep --multihost counts {outs['multihost']}; sweep "
          f"{outs['plain']}", flush=True)
    if outs["multihost"] != outs["plain"]:
        fail("sweep --multihost on one rank differs from sweep")

    # scaling-probe on the one card: one row
    out = os.path.join(tmp, "probe")
    cli_main(["scaling-probe", *flags[:-2], "--devices", "1,2,4,8",
              "--per-dev-cw", str(batch), "--out", out])
    (path,) = os.listdir(out)
    with open(os.path.join(out, path)) as f:
        probe = json.load(f)
    print(f"  scaling-probe: devices {probe['devices']}, bits/s "
          f"{probe['bits_per_s']}, host_frac {probe['host_frac']} "
          f"[{card}]", flush=True)
    if probe["devices"] != [1] or not probe["bits_per_s"][0] > 0:
        fail(f"scaling-probe: {probe}")

    # run_grid: each point the mc_step of its derived seed
    got = run_grid(code, f20, snrs, batch, seed=9, device="cuda")
    step = mc_step(code, f20, batch, device="cuda")
    for p, snr in enumerate(snrs):
        want = step(stable_seed(9, p), snr)
        row = {k: int(got[k][p]) for k in want}
        print(f"  run_grid @ {snr:g} dB: {row}", flush=True)
        if row != {k: int(v) for k, v in want.items()}:
            fail(f"run_grid @ {snr:g} dB differs from its mc_step")
    return {"launches": launched["minsum_qc_flooding"],
            "points": len(snrs), "llrs": eval_llrs}


def library_phase(card: str) -> dict:
    """Phase 3j: the rest of the library and the CLI. ``train-grid`` then
    ``evaluate-grid`` on ref6432 against the committed grid artifact and on
    wifi1944 min-sum flooding-20 (the flooding kernel three times a cell),
    a resumed ``train-grid``; the DE threshold example on qc1944_r56; the
    error-floor campaign on wifi1944 at 2.5 dB; ``noise-study``,
    ``evaluate-joint``, ``code-info --de`` and the joint before/after
    example. Returns the launches and the inputs of the kernels line's
    rows."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_3j_") as tmp:
        return _library_phase(card, tmp)


def _within_frames(label: str, got: float, want: float, frames: float,
                   card: str) -> None:
    """Hold an error rate to a reference within 4/√(frames in error),
    relative."""
    tol = 4 / math.sqrt(max(frames, 1.0))
    rel = abs(got - want) / want if want else float(got != 0.0)
    print(f"  {label}: {got!r} against {want!r} (relative difference "
          f"{rel:.4f}, limit 4/sqrt({frames:.0f}) = {tol:.4f}) [{card}]",
          flush=True)
    if not rel <= tol:
        fail(f"{label}: {got} is not within 4/sqrt(frames in error) of "
             f"{want}")


def _read_one(directory: str, suffix: str) -> dict:
    (name,) = [f for f in os.listdir(directory) if f.endswith(suffix)]
    with open(os.path.join(directory, name)) as f:
        return json.load(f)


def _library_phase(card: str, tmp: str) -> dict:
    import numpy as np
    import torch

    from ldpc_sims_tpu_torch.cli.main import main as cli_main
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.convert import (
        joint_params_to_flax,
        llr_state_dict_from_flax,
    )
    from ldpc_sims_tpu_torch.examples import de_thresholds
    from ldpc_sims_tpu_torch.examples import error_floor_campaign as efc
    from ldpc_sims_tpu_torch.grid import GRID_KEYS
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.models import Joint, LLRestimator
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig, link_step
    from ldpc_sims_tpu_torch.utils import (
        find_runs,
        load_checkpoint,
        save_checkpoint,
    )

    out = {}

    def launched() -> dict:
        return {k: v for k, v in mq.LAUNCHES.items() if v}

    # (a) the ref6432 family as the committed grid ran it (the CLI's
    # decoder defaults: sum-product-ref-3, clamp 20, on the gather
    # backend), training cut to 2 epochs: its Traditional and quantized
    # columns do not depend on the estimators
    with open(GRID_ARTIFACT) as f:
        art = json.load(f)
    fam = os.path.join(tmp, "ref")
    grid = ["train-grid", "--code", "ref6432", "--snr",
            ",".join(f"{s:g}" for s in GRID_SNRS), "--qbits-grid", "3",
            "--clipdb-grid", "0", "--epochs", "2", "--family", "ref",
            "--out", fam]
    t0 = time.perf_counter()
    cli_main(grid)
    t_train = time.perf_counter() - t0
    cells = len(find_runs("train-llr", fam, family="ref"))
    t0 = time.perf_counter()
    cli_main(grid)  # resumed: every cell exists
    t_resume = time.perf_counter() - t0
    if len(find_runs("train-llr", fam, family="ref")) != cells or cells != (
            2 * len(GRID_SNRS)):
        fail(f"train-grid: {cells} cells, then "
             f"{len(find_runs('train-llr', fam, family='ref'))} after the "
             "resume")
    n = art["num_codewords"]
    t0 = time.perf_counter()
    cli_main(["evaluate-grid", "--code", "ref6432", "--family", "ref",
              "--batch", str(n), "--out", fam])
    t_eval = time.perf_counter() - t0
    got = _read_one(fam, "_grid_ref.json")
    print(f"  train-grid ref6432 ({cells} cells, 2 epochs): {t_train:.1f} s; "
          f"resumed: {t_resume:.2f} s, no cell trained; evaluate-grid at "
          f"{n} codewords: {t_eval:.1f} s [{card}]", flush=True)
    for i, snr in enumerate(GRID_SNRS):
        j = art["snrdb"].index(snr)
        for col, fcol in (("coded_ber", "coded_bler"),
                          ("coded_ber_qllr", "coded_bler_qllr")):
            frames = 0.5 * n * (got[fcol][i][0][0] + art[fcol][j][0][0])
            _within_frames(f"evaluate-grid ref6432 {col} @ {snr:g} dB",
                           got[col][i][0][0], art[col][j][0][0], frames,
                           card)
        if not all(math.isfinite(got[k][i][0][0])
                   for k in ("coded_ber_nn", "wmse_nn", "wmse_qllr")):
            fail(f"evaluate-grid ref6432 @ {snr:g} dB: non-finite NN columns")

    # (b) the wifi1944 family, decoded by min-sum flooding-20
    fam = os.path.join(tmp, "w1944")
    flags = ["--code", "wifi1944", "--method", "min-sum", "--iters", "20"]
    snrs = (1.5, 2.0, 2.5)
    t0 = time.perf_counter()
    cli_main(["train-grid", *flags, "--snr", ",".join(map(str, snrs)),
              "--qbits-grid", "3", "--clipdb-grid", "0", "--epochs", "2",
              "--family", "w", "--out", fam])
    t_train = time.perf_counter() - t0
    batch = 32768
    mq.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["evaluate-grid", *flags, "--family", "w", "--batch",
              str(batch), "--out", fam])
    t_eval = time.perf_counter() - t0
    counts, entries = launched(), dict(mq.ENTRY_LAUNCHES)
    got = _read_one(fam, "_grid_w.json")
    print(f"  train-grid wifi1944 (6 cells, 2 epochs): {t_train:.1f} s; "
          f"evaluate-grid at batch {batch}: {t_eval:.2f} s for "
          f"{len(snrs)} cells; launches {counts}, entry points {entries} "
          f"[{card}]", flush=True)
    for k in ("coded_ber", "coded_ber_qllr", "coded_ber_nn"):
        print(f"  evaluate-grid wifi1944 {k}: "
              f"{[c[0][0] for c in got[k]]}", flush=True)
    if counts != {"minsum_qc_flooding": 3 * len(snrs)}:
        fail(f"evaluate-grid launched {counts}, not minsum_qc_flooding "
             "three times a cell")
    trad = [c[0][0] for c in got["coded_ber"]]
    if not all(math.isfinite(x) for k in GRID_KEYS for c in got[k]
               for x in c[0]) or not trad[0] > trad[-1]:
        fail(f"evaluate-grid wifi1944: {got}")
    # a cell's three LLR sets (Traditional, Quantized, NN) at 2.0 dB, for
    # the kernels line's row
    code = get_code("wifi1944")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    arrays = link_step(gen, 2.0, code, LinkConfig(
        bp_method="min-sum", bp_iterations=20, qbits=3), batch,
        return_arrays=True)
    (cell,) = find_runs("train-llr", fam, family="w", stage="quantized",
                        snrdb=2.0)
    model = LLRestimator(32)
    model.load_state_dict(llr_state_dict_from_flax(
        load_checkpoint(cell["ckpt"])[0]["params"]))
    sig = arrays["q_time"].reshape(-1, 32)
    with torch.no_grad():
        nn = model.to("cuda")(torch.cat([sig.real, sig.imag], dim=1))
    out["grid"] = {"launches": counts["minsum_qc_flooding"],
                   "cells": len(snrs),
                   "llrs": {"trad": arrays["llrs"], "quant": arrays["qllrs"],
                            "nn": nn.reshape(-1, code.n)}}

    # (c) density evolution and the measured waterfall on qc1944_r56
    with open(DE_ARTIFACT) as f:
        de_art = json.load(f)["codes"][DE_CODE]
    de_out = os.path.join(tmp, "de.json")
    env = dict(DE_CODES=DE_CODE, DE_OUT=de_out)
    mq.reset_launch_counts()
    with _environ(env):
        de_thresholds.main()
    counts, entries = launched(), dict(mq.ENTRY_LAUNCHES)
    with open(de_out) as f:
        ent = json.load(f)["codes"][DE_CODE]
    print(f"  de_thresholds {DE_CODE} (8192 samples): DE wall "
          f"{ent['de_wall_s']} s for the three thresholds, th(min-sum, 20) "
          f"{ent['th_minsum_20it_db']} dB (artifact "
          f"{de_art['th_minsum_20it_db']}), th(min-sum) "
          f"{ent['th_minsum_db']} ({de_art['th_minsum_db']}), "
          f"th(sum-product) {ent['th_sumproduct_db']} "
          f"({de_art['th_sumproduct_db']}); measured 1e-3 crossing "
          f"{ent['measured_1e3_crossing_db']} dB "
          f"({de_art['measured_1e3_crossing_db']}) in "
          f"{ent['measure_wall_s']} s, gap {ent['gap_db']}, consistent "
          f"{ent['consistent']}; launches {counts}, entry points {entries} "
          f"[{card}]", flush=True)
    for key in ("th_minsum_20it_db", "measured_1e3_crossing_db"):
        if not abs(ent[key] - de_art[key]) <= 0.15:
            fail(f"de_thresholds {DE_CODE} {key}: {ent[key]} is not within "
                 f"0.15 dB of {de_art[key]}")
    if list(counts) != ["minsum_qc_flooding"] or not ent["consistent"]:
        fail(f"de_thresholds: launched {counts}, consistent "
             f"{ent['consistent']}")
    out["de"] = {"launches": counts["minsum_qc_flooding"],
                 "snr": ent["measured_1e3_crossing_db"]}

    # (d) the error-floor campaign on wifi1944 at 2.5 dB, every schedule
    # of the committed registry, 2 chunks of 32 steps at batch 32768
    with open(FLOOR_ARTIFACT) as f:
        floor_art = {(p["schedule"], p["snr_db"]): p
                     for p in json.load(f)["points"]}
    rec_path = os.path.join(tmp, "floor.json")
    steps = 64
    env = dict(EF_CODE="wifi1944", EF_SNRS=f"{EF_SNR}", EF_BATCH=str(batch),
               EF_CHUNK_STEPS="32",
               EF_TARGET_BITS=str(steps * batch * code.k), EF_OUT=rec_path)
    artifacts_before = _artifact_digests()
    mq.reset_launch_counts()
    t0 = time.perf_counter()
    with _environ(env):
        efc.main()
    t_floor = time.perf_counter() - t0
    counts, entries = launched(), dict(mq.ENTRY_LAUNCHES)
    with open(rec_path) as f:
        rec = json.load(f)
    print(f"  error-floor campaign wifi1944 @ {EF_SNR:g} dB, "
          f"{len(rec['points'])} schedules x {steps} steps of {batch}: "
          f"{t_floor:.1f} s; launches {counts}, entry points {entries} "
          f"[{card}]", flush=True)
    for p in rec["points"]:
        print(f"    {p['schedule']}: FER {p['fler']!r} ({p['frame_errs']} of "
              f"{p['frames']}), BER {p['ber']!r}, {p['wall_s']:.2f} s",
              flush=True)
    print(f"    verdicts: { {k: [v['floor_ok'] for v in vs] for k, vs in rec['verdicts'].items()} }",
          flush=True)
    for name in EF_HELD:
        (p,) = [q for q in rec["points"] if q["schedule"] == name]
        ref = floor_art[name, EF_SNR]
        # frames in error: this run's and the reference's at its exposure
        _within_frames(f"error floor {name} FER @ {EF_SNR:g} dB",
                       p["fler"], ref["fler"],
                       0.5 * (p["frame_errs"] + ref["fler"] * p["frames"]),
                       card)
    if _artifact_digests() != artifacts_before:
        fail("the error-floor campaign wrote under docs/artifacts/")
    if not os.path.exists(os.path.splitext(rec_path)[0]
                          + "_schedules.json"):
        fail("the error-floor campaign wrote no registry copy")
    for k in ("minsum_qc_flooding", "minsum_qc_layered",
              "minsum_qc_layered_w"):
        if not counts.get(k):
            fail(f"the error-floor campaign launched no {k}: {counts}")
    out["floor"] = {"counts": counts, "steps": steps,
                    "schedules": dict(efc.schedules_from_registry(
                        "wifi1944", json.load(open(SCHEDULES)),
                        os.path.dirname(SCHEDULES), torch.device("cuda")))}

    # (e) noise-study, evaluate-joint and code-info --de, once each
    ns = os.path.join(tmp, "noise")
    mq.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["noise-study", "--out", ns])
    recs = _read_one(ns, "_noise_study.json")
    print(f"  noise-study (ref6432, 0/5/10 dB x qbits 1/3/5, 512 codewords): "
          f"{time.perf_counter() - t0:.2f} s; std "
          f"{[round(r['std'], 4) for r in recs]}, launches {launched()} "
          f"[{card}]", flush=True)
    if len(recs) != 9 or not all(math.isfinite(r["std"]) for r in recs):
        fail(f"noise-study: {recs}")
    model = Joint(code_name="ref6432", iterations=3,
                  generator=torch.Generator().manual_seed(8))
    ckpt = save_checkpoint(os.path.join(tmp, "joint"),
                           {"params": joint_params_to_flax(model),
                            "opt_state": None}, {"model": "Joint"})
    ej = os.path.join(tmp, "joint_eval")
    t0 = time.perf_counter()
    cli_main(["evaluate-joint", "--qbits", "3", "--ckpt", ckpt, "--out", ej])
    curves = _read_one(ej, "_joint_eval.json")
    print(f"  evaluate-joint (ref6432, 3-bit ADC, 0:6:4 dB, 1024 codewords, "
          f"a seeded Joint): {time.perf_counter() - t0:.2f} s; "
          f"{ {k: v for k, v in curves.items() if k != 'code'} } [{card}]",
          flush=True)
    if not all(math.isfinite(x) for k, v in curves.items() if k != "code"
               for x in v) or not curves["ber_classic"][-1] < curves[
                   "ber_classic"][0]:
        fail(f"evaluate-joint: {curves}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(["code-info", "--code", "wifi648", "--de"])
    rep = json.loads(buf.getvalue())
    print(f"  code-info --code wifi648 --de: {time.perf_counter() - t0:.1f} "
          f"s; cycles {rep['qc']['cycles_4']}/{rep['qc']['cycles_6']}, DE "
          f"thresholds {rep['de_threshold_db']} [{card}]", flush=True)
    th = rep["de_threshold_db"]
    if not th["sum-product"] < th["min-sum"] < 3.0:
        fail(f"code-info --de: {rep}")

    # (f) the joint before/after example, its joint training cut from 40
    # epochs to 3 (the other stages at the example's sizes)
    from ldpc_sims_tpu_torch.examples import joint_before_after

    with open(JOINT_ARTIFACT) as f:
        jart = json.load(f)
    t0 = time.perf_counter()
    jrec = joint_before_after.run(torch.device("cuda"), joint_epochs=3)
    print(f"  joint_before_after (joint training 3 of 40 epochs): "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    for k in ("ber_classic", "ber_quantized_llr", "ber_joint_before",
              "ber_joint_after"):
        print(f"    {k} at {jrec['snrdb']} dB: {jrec[k]} (artifact "
              f"{jart[k]})", flush=True)
        if not all(math.isfinite(x) for x in jrec[k]):
            fail(f"joint_before_after: non-finite {k}")
    if not jrec["ber_classic"][-1] < jrec["ber_classic"][0]:
        fail(f"joint_before_after: classic BER {jrec['ber_classic']}")
    return out


def examples_phase(card: str) -> dict:
    """Phase 3k: the seven training and study examples through their
    ``run()`` on the card, their training cut (``EXAMPLE_CUTS``), each held
    to its committed record; nothing under ``docs/artifacts/`` changes.
    Returns each example's launches and what phase 4's rows need."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_3k_") as tmp:
        return _examples_phase(card, tmp)


def _held(label: str, got: float, want: float, frames: float, se,
          card: str) -> None:
    """Hold an error rate to a committed one within the larger of
    4/√(frames in error) and 4σ of the difference of two estimates at the
    same exposure (σ = √2 × this run's standard error ``se``, from its
    per-frame counts; None: √2 × want/√frames), relative."""
    frames = max(frames, 1.0)
    sig = (math.sqrt(2) * se / want if se is not None
           else math.sqrt(2 / frames))
    tol = max(4 / math.sqrt(frames), 4 * sig)
    rel = abs(got - want) / want
    print(f"  {label}: {got!r} against {want!r} (relative difference "
          f"{rel:.4f}; 4/sqrt({frames:.0f}) = {4 / math.sqrt(frames):.4f}, "
          f"4 sigma = {4 * sig:.4f}) [{card}]", flush=True)
    if not rel <= tol:
        fail(f"{label}: {got} is not within {tol:.4f} (relative) of {want}")


def pallas_sumproduct_excl(x, serial: bool = True):
    """The exclusive sum-product of ``ops/bp_roll.py:_sumproduct_excl`` in
    the JAX Pallas kernel's arithmetic (ldpc_sims_tpu/kernels/
    minsum_qc.py:62-78, :333-343): |x| capped at 80, log(1 − e^−a) by a
    six-term series below 0.2 and directly above (floored at 1e-30),
    log(1 + e^x) for log1p."""
    import torch

    from ldpc_sims_tpu_torch.ops.bp_roll import _exclusive_sign

    def log1mexp(a):
        direct = torch.clamp_min(1.0 - torch.exp(-a), 1e-30)
        series = a * (1.0 - a / 2 * (1.0 - a / 3 * (1.0 - a / 4 * (
            1.0 - a / 5 * (1.0 - a / 6)))))
        return torch.log(torch.where(a > 0.2, direct,
                                     torch.clamp_min(series, 1e-30)))

    a = torch.clamp(x.abs(), 1e-12, 80.0)
    lt = log1mexp(a) - torch.log(1.0 + torch.exp(-a))
    s = torch.clamp_max(lt.sum(0, keepdim=True) - lt, -1e-12)
    mag = torch.log(1.0 + torch.exp(s)) - log1mexp(-s)
    return _exclusive_sign(x) * mag


def _examples_phase(card: str, tmp: str) -> dict:
    import numpy as np
    import torch

    from ldpc_sims_tpu_torch.examples import (
        quantized_llr_study,
        tanh_family,
        train_edge_1944,
        train_edge_layered_1944,
        train_minsum_1944,
        train_minsum_short,
        train_minsum_tail7,
    )
    import ldpc_sims_tpu_torch.ops.bp_roll as br
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.examples import error_floor_campaign as efc
    from ldpc_sims_tpu_torch.examples.paired import count_errors
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq

    dev = torch.device("cuda")
    cut = EXAMPLE_CUTS
    artifacts_before = _artifact_digests()
    out = {"launches": {}}

    def load(path):
        with open(path) as f:
            return json.load(f)

    def timed(name, fn):
        mq.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in mq.LAUNCHES.items() if v}
        out["launches"][name] = counts
        print(f"  {name}: {wall:.1f} s; launches {counts}, entry points "
              f"{dict(mq.ENTRY_LAUNCHES)} [{card}]", flush=True)
        return res, counts

    def expect(name, counts, want):
        if counts != want:
            fail(f"{name} launched {counts}, not {want}: a gradient decode "
                 "on a kernel, or an evaluation off them")

    # (a) quantized_llr_study at its docstring's size: the Traditional
    # column against BASELINE.md table A (4σ + 10%, as phase 3f)
    curves, counts = timed("quantized_llr_study", lambda: (
        quantized_llr_study.run(dev, num_codewords=cut["quantized_codewords"],
                                epochs=cut["quantized_epochs"])))
    expect("quantized_llr_study", counts, {})
    bits = 4096 * 32
    for snr in (0.0, 6.0):
        i = curves["snrdb"].index(snr)
        got, exp = curves["coded_ber"][i], TABLE_A[snr]
        tol = 4 * math.sqrt(exp * (1 - exp) / bits) + 0.1 * exp
        print(f"  quantized_llr_study Traditional @ {snr:g} dB: {got!r} "
              f"against table A's {exp!r} (4σ + 10% = {tol!r}); NN "
              f"{curves['coded_ber_nn'][i]!r}, Quantized "
              f"{curves['coded_ber_qllr'][i]!r} [{card}]", flush=True)
        if abs(got - exp) > tol:
            fail(f"quantized_llr_study @ {snr:g} dB: {got} not within "
                 f"4σ + 10% of {exp}")
    if not all(math.isfinite(x) for k, v in curves.items() for x in v):
        fail(f"quantized_llr_study: non-finite curves {curves}")

    # (b) tanh_family, 60 of 600 epochs: both arms' estimator-independent
    # columns equal, and against the record, pooled over the six points
    # (one channel: the SNR is drawn per symbol, the grid's is unused)
    rec, counts = timed("tanh_family", lambda: tanh_family.run(
        dev, os.path.join(tmp, "tanh"), epochs=cut["tanh_epochs"]))
    expect("tanh_family", counts, {})
    art = load(TANH_ARTIFACT)["arms"]["plain"]["curves"]
    plain, tanh = (rec["arms"][a]["curves"] for a in ("plain", "tanh"))
    for col in tanh_family.SHARED_COLUMNS:
        if plain[col] != tanh[col]:
            fail(f"tanh_family: the arms' {col} differ")
    n_pts = len(plain["snrdb"])
    for col, fcol in TANH_HELD.items():
        frames = n_pts * 4096 * (1.0 if fcol is None
                                 else sum(plain[fcol]) / n_pts)
        _held(f"tanh_family {col} (6 points pooled)",
              sum(plain[col]) / n_pts, sum(art[col]) / n_pts, frames, None,
              card)
    for tag in ("plain", "tanh"):
        c = rec["arms"][tag]["curves"]
        nn = {k: c[k] for k in ("coded_ber_nn", "wmse_nn", "wmse_nn_flipped")
              if k in c}
        print(f"    {tag}: final loss {rec['arms'][tag]['final_train_loss']!r}"
              f", {nn}", flush=True)
        if not all(math.isfinite(x) for v in c.values() for x in v):
            fail(f"tanh_family {tag}: non-finite curves")

    # (c) train_minsum_1944, 32 of 120 training steps, the evaluation at
    # the JAX budget (31 steps of 32768 a point and arm)
    rec, counts = timed("train_minsum_1944", lambda: train_minsum_1944.run(
        dev, train_steps=cut["ms_train_steps"]))
    steps = 31
    expect("train_minsum_1944", counts, {
        "minsum_qc_layered": 2 * 3 * steps + 2 * 7,
        "sumproduct_qc_layered": 3 * steps, "minsum_qc_flooding": 3 * steps})
    art = load(MINSUM_ARTIFACT)["ber"]
    trained = "minsum_trained_layered10"
    for arm in ("minsum_plain_layered10", "sumproduct_layered10",
                "minsum_plain_flooding20"):
        for snr in ("1.5", "1.75", "2.0"):
            st = rec["stats"][arm][snr]
            if (arm, snr) != SP_SATURATED:
                _held(f"train_minsum_1944 {arm} @ {snr} dB",
                      rec["ber"][arm][snr], art[arm][snr], st["frame_errs"],
                      st["ber_se"], card)
                continue
            got, want = rec["ber"][arm][snr], art[arm][snr]
            tol = max(4 / math.sqrt(max(st["frame_errs"], 1)),
                      4 * math.sqrt(2) * st["ber_se"] / want)
            print(f"  train_minsum_1944 {arm} @ {snr} dB: {got!r}, at most "
                  f"the record's {want!r} (+ {tol:.4f} relative), whose "
                  f"Pallas kernel saturates [{card}]", flush=True)
            if not got <= want * (1 + tol):
                fail(f"train_minsum_1944 {arm} @ {snr} dB: {got} above the "
                     f"record's {want}")
            # the same frames through the plain decode in the Pallas
            # kernel's arithmetic: the record's number
            exact = br._sumproduct_excl
            br._sumproduct_excl = pallas_sumproduct_excl
            try:
                t0 = time.perf_counter()
                c = count_errors(get_code("wifi1944"), dict(
                    iterations=10, schedule="layered", method="sum-product",
                    backend="roll"), float(snr), steps, 32768,
                    train_minsum_1944.KEY, dev, info_bits=True)
            finally:
                br._sumproduct_excl = exact
            print(f"    the plain decode in the Pallas arithmetic: BER "
                  f"{c.ber!r} ({c.bit_errs} errors in {c.frame_errs} frames, "
                  f"against {st['frame_errs']} frames of the exact rule; "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
            _held(f"train_minsum_1944 {arm} @ {snr} dB, Pallas arithmetic",
                  c.ber, want, c.frame_errs, c.ber_se, card)
    print(f"    trained layered-10: BER {rec['ber'][trained]} (record, 120 "
          f"steps: {art[trained]}), BCE {rec['train']['loss_first']!r} -> "
          f"{rec['train']['loss_last']!r}; ms a step {rec['throughput']}",
          flush=True)
    if not (rec["ber"][trained]["1.5"]
            < rec["ber"]["minsum_plain_layered10"]["1.5"]):
        fail("train_minsum_1944: the trained layered-10 is not below plain "
             "layered-10 at 1.5 dB")
    out["minsum_1944"] = {"alpha": rec["alpha"], "beta": rec["beta"]}

    # (d) train_minsum_short, 16 of 120 training steps a K
    (rec, schedules), counts = timed(
        "train_minsum_short", lambda: train_minsum_short.run(
            dev, train_steps=cut["short_train_steps"]))
    expect("train_minsum_short", counts, {
        "minsum_qc_flooding": 2 * steps + 7,
        "minsum_qc_layered": 2 * (2 * steps + 7)})
    art = load(SHORT_ARTIFACT)["arms"]["flooding20"]["ber"]
    for snr in ("1.75", "2.25"):
        st = rec["arms"]["flooding20"]["stats"][snr]
        _held(f"train_minsum_short flooding20 @ {snr} dB",
              rec["arms"]["flooding20"]["ber"][snr], art[snr],
              st["frame_errs"], st["ber_se"], card)
    for K in (6, 8):
        arm = rec["arms"][f"trained_layered{K}"]
        print(f"    trained layered-{K}: BER {arm['ber']}, parity "
              f"{arm['parity_vs_flooding20']}, {arm['timing']}", flush=True)
    print(f"    registry entries: {sorted(schedules)}", flush=True)

    # the guard's control of tail7 and edge-layered: flooding-20's coded
    # bit errors at 1.75 and 2.25 dB (key 55), 31 steps of 32768
    el_art = load(EDGE_LAYERED_ARTIFACT)["ber"]

    def held_errs(label, errs, stats, arm):
        for snr in ("1.75", "2.25"):
            st = stats[snr]
            _held(f"{label} {arm} @ {snr} dB", errs[snr] / st["coded_bits"],
                  el_art[arm][snr]["ber"], st["frame_errs"], st["ber_se"],
                  card)

    # (e) train_minsum_tail7, 16 of 3000 steps
    rec, counts = timed("train_minsum_tail7", lambda: train_minsum_tail7.run(
        dev, steps=cut["t7_steps"]))
    n_probe = cut["t7_steps"] * 3  # a probe every step: 16 // 10 < 2
    expect("train_minsum_tail7", counts, {
        "minsum_qc_flooding": 4 * steps,
        "minsum_qc_layered": 4 * steps + n_probe})
    held_errs("train_minsum_tail7 control", rec["guard_errs"]["ctrl"],
              rec["guard_stats"]["ctrl"], "flooding-20")
    print(f"    errors {rec['guard_errs']}, verdict {rec['verdict']} "
          f"(2.75 and 3.25 dB recorded, not held); BCE {rec['bce']}",
          flush=True)
    out["tail7"] = {"alpha": rec["alpha"], "beta": rec["beta"]}

    # (f) train_edge_1944, 16 of 300 steps
    (rec, weights), counts = timed(
        "train_edge_1944", lambda: train_edge_1944.run(
            dev, steps=cut["edge_steps"]))
    expect("train_edge_1944", counts, {
        "minsum_qc_flooding": 4 * steps, "minsum_qc_flooding_w": 2 * steps})
    art = load(EDGE_ARTIFACT)["ber"]
    for arm in ("flooding-12 plain", "flooding-20 plain"):
        for snr in ("1.75", "2.25"):
            st = rec["stats"][arm][snr]
            _held(f"train_edge_1944 {arm} @ {snr} dB", rec["ber"][arm][snr],
                  art[arm][snr], st["frame_errs"], st["ber_se"], card)
    print(f"    flooding-12 per-edge: {rec['ber']['flooding-12 per-edge']} "
          f"(16 steps; the record's 300: "
          f"{art['flooding-12 per-edge']}); BCE {rec['bce']}", flush=True)
    out["edge"] = weights

    # (g) train_edge_layered_1944 (EL_JOINT), 16 of 1500 steps, its record,
    # npz and registry copy under a temporary directory
    el_out = os.path.join(tmp, "el", "edge_layered.json")
    rec, counts = timed(
        "train_edge_layered_1944", lambda: train_edge_layered_1944.run(
            dev, el_out, steps=cut["el_steps"]))
    n_probe = cut["el_steps"] * 3
    expect("train_edge_layered_1944", counts, {
        "minsum_qc_flooding": 4 * steps,
        "minsum_qc_layered": 2 * 4 * steps + 4 * 32,
        "minsum_qc_layered_w": 4 * steps + n_probe + 4 * 32})
    res = rec["ber"]
    for arm in ("flooding-20", "layered-6 plain", "trained-layered-8"):
        held_errs("train_edge_layered_1944", {s: p["errs"] for s, p in
                                              res[arm].items()},
                  res[arm], arm)
    for arm, pts in res.items():
        print(f"    {arm}: errors " + ", ".join(
            f"{s} dB {p['errs']} ({p['frame_errs']} frames)"
            for s, p in pts.items()), flush=True)
    print(f"    verdict {rec['parity_vs_flooding20']}; pipe rates "
          f"{rec['pipe_bits_per_s']} info bits/s; BCE {rec['bce']}",
          flush=True)
    copy = os.path.splitext(el_out)[0] + "_schedules.json"
    names = [n for n, _ in efc.schedules_from_registry(
        "wifi1944", load(copy), os.path.dirname(el_out), dev)]
    if "edge-layered-6" not in names:
        fail(f"the edge-layered registry copy gives {names}")
    with np.load(os.path.splitext(el_out)[0] + ".npz") as z:
        out["edge_layered"] = {k: z[k] for k in z.files}
    if _artifact_digests() != artifacts_before:
        fail("an example wrote under docs/artifacts/")
    print("  docs/artifacts/ unchanged", flush=True)
    return out


@contextlib.contextmanager
def _environ(env: dict):
    """``os.environ`` with ``env`` set, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _artifact_digests() -> dict:
    import hashlib

    d = os.path.join(ROOT, "docs", "artifacts")
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


def training_phase(card: str, sweep) -> dict:
    """Phase 3i: training on the card. ``train-minsum`` as a user runs it
    and its schedule through ``sweep --schedule-ckpt`` beside plain
    layered-10 (``sweep``: phase 3's points, steps and seed), the roll
    training step's time and idle share, ``train_neural_bp`` with its
    probe on the ``_w`` kernel, ``train_llr`` card against CPU with the
    ``train-llr`` and ``generate-data`` subcommands, ``train-joint`` and
    its checkpoint's key tree. Returns what phase 4's rows need: the
    launches, the trained α/β and edge weights."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_3i_") as tmp:
        return _training_phase(card, sweep, tmp)


def _key_tree(tree):
    """A checkpoint tree's keys, its leaves replaced by their dtype."""
    if isinstance(tree, dict):
        return {k: _key_tree(v) for k, v in tree.items()}
    return str(getattr(tree, "dtype", type(tree).__name__))


def _training_phase(card: str, sweep, tmp: str) -> dict:
    import numpy as np
    import torch

    from ldpc_sims_tpu_torch.cli.main import (
        build_parser,
        sweep_configs,
    )
    from ldpc_sims_tpu_torch.cli.main import main as cli_main
    from ldpc_sims_tpu_torch.codes import get_code
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.kernels.compare import floor_llrs
    from ldpc_sims_tpu_torch.models import LLRestimator
    from ldpc_sims_tpu_torch.ops import bp_decode
    from ldpc_sims_tpu_torch.ops.bp import (
        init_minsum_weights,
        init_neural_bp_weights,
    )
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig
    from ldpc_sims_tpu_torch.training import (
        TrainConfig,
        decoded_ber_probe,
        make_llr_dataset,
        train_llr,
        train_neural_bp,
    )
    from ldpc_sims_tpu_torch.training.trainer import (
        minsum_batch,
        minsum_step,
    )
    from ldpc_sims_tpu_torch.utils import load_checkpoint, load_runs

    w1944 = get_code("wifi1944")
    batch = sweep.batch_cw
    out = {}

    # (a) train-minsum as the artifact's recipe, on the plain version
    t0 = time.perf_counter()
    runs = os.path.join(tmp, "minsum")
    mq.reset_launch_counts()
    cli_main(MINSUM_TRAIN_FLAGS + ["--out", runs])
    t_train = time.perf_counter() - t0
    if sum(mq.LAUNCHES.values()):
        fail(f"train-minsum launched kernels in its gradient decodes: "
             f"{ {k: v for k, v in mq.LAUNCHES.items() if v} }")
    ckpt = load_runs(runs)[-1]["ckpt"]
    _, mani = load_checkpoint(ckpt)
    loss = mani["loss"]
    first, last = float(np.mean(loss[:10])), float(np.mean(loss[-10:]))
    print(f"  train-minsum: {len(loss)} steps in {t_train:.1f} s, BCE mean "
          f"of the first 10 {first!r}, of the last 10 {last!r} (ratio "
          f"{last / first:.3f}; the artifact's first/last step 0.04887 / "
          f"0.01664) [{card}]", flush=True)
    if not last < 0.6 * first:
        fail(f"train-minsum: the last 10 steps' BCE {last} is not below "
             f"0.6 x the first 10's {first}")
    base = ["sweep", "--code", "wifi1944", "--method", "min-sum",
            "--schedule", "layered", "--iters", "10", "--clamp", "0"]
    _, t_cfg, _, _, _ = sweep_configs(build_parser().parse_args(
        base + ["--schedule-ckpt", ckpt]))
    _, p_cfg, _, _, _ = sweep_configs(build_parser().parse_args(base))
    if t_cfg.alpha != tuple(mani["alpha"]) or t_cfg.beta != tuple(
            mani["beta"]):
        fail("sweep --schedule-ckpt did not take the trained schedule")
    res_t, counts, ev, rate_t = drive(
        "trained layered-10 (train-minsum)", w1944, t_cfg, sweep,
        ["minsum_qc_layered"], card)
    out["minsum_launches"] = counts["minsum_qc_layered"]
    out["minsum_per_step"] = counts["minsum_qc_layered"] / ev.mc_steps
    if out["minsum_per_step"] != 1:
        fail(f"trained layered-10: {counts} over {ev.mc_steps} mc_steps, "
             "not one minsum_qc_layered a step")
    res_p, _, _, rate_p = drive("plain layered-10", w1944, p_cfg, sweep,
                                ["minsum_qc_layered"], card)
    for snr, bt, bp in zip(res_t.snrdb, res_t.coded_ber, res_p.coded_ber):
        ref = (f"; the artifact's {MINSUM_TRAINED_BER['trained']!r} "
               f"against {MINSUM_TRAINED_BER['plain']!r}"
               if snr == 1.5 else "")
        print(f"  @ {snr:g} dB: coded BER trained layered-10 {bt!r}, plain "
              f"layered-10 {bp!r} ({bp / max(bt, 1e-300):.2f}x{ref}) "
              f"[{card}]", flush=True)
        if snr == 1.5 and not bt < bp / 3:
            fail(f"trained layered-10 @ 1.5 dB: coded BER {bt} is not below "
                 f"a third of plain layered-10's {bp}")
    out["alpha"], out["beta"] = t_cfg.alpha, t_cfg.beta
    # the decoded-BER probe with the trained ms arrays (tensors that need a
    # gradient, as the trainer holds them): the α/β table of
    # minsum_qc_layered, one launch a point
    ms = {k: torch.tensor(v, device="cuda", requires_grad=True)
          for k, v in (("ms_alpha", mani["alpha"]),
                       ("ms_beta", mani["beta"]))}
    probe = decoded_ber_probe(w1944, (1.5,), batch=batch, device="cuda",
                              iterations=10, method="min-sum",
                              schedule="layered", clamp=None)
    mq.reset_launch_counts()
    ber = probe(ms, 14)[1.5]
    counts = {k: v for k, v in mq.LAUNCHES.items() if v}
    print(f"  probe with the trained ms arrays @ 1.5 dB (BPSK, all n bits): "
          f"BER {ber!r}, launches {counts} [{card}]", flush=True)
    if counts != {"minsum_qc_layered": 1}:
        fail(f"the probe with ms weights launched {counts}, not "
             "minsum_qc_layered once")
    # the roll training step alone: CUDA-synchronized wall over 5 steps,
    # then one under the profiler for its device time and idle share
    w = {k: v.cuda().requires_grad_()
         for k, v in init_minsum_weights(10).items()}
    opt = TrainConfig(optimizer="adam", learning_rate=0.02).make_optimizer(
        w.values())
    gen = torch.Generator(device="cuda").manual_seed(9)
    kw = dict(iterations=10, schedule="layered", clamp=None)

    def step(seed, snrdb):
        llr = minsum_batch(gen, w1944, 256, 1.25, 2.5)
        return {"loss": minsum_step(w, opt, w1944, llr, **kw)}

    step(0, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(0, 0.0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"  roll training step (wifi1944 layered-10, batch 256, adam): "
          f"{step_ms!r} ms a step [{card}]", flush=True)
    profile_step(step, "roll training step", card,
                 what="train-minsum step (wifi1944 layered-10, batch 256)")
    out["step_ms"] = step_ms

    # (b) train_neural_bp, the K6 recipe: its probes on the _w kernel, the
    # first one (the all-ones init) against plain layered-6
    t0 = time.perf_counter()
    r = K6_RECIPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    llrs = minsum_batch(gen, w1944, r["batches"] * r["batch"],
                        *r["snr"]).cpu().numpy()
    lay6 = dict(iterations=6, method="min-sum", clamp=None,
                schedule="layered")
    probe = decoded_ber_probe(w1944, (2.0, 2.5), batch=batch, device="cuda",
                              **lay6)
    init = {k: v.cuda() for k, v in init_neural_bp_weights(w1944, 6).items()}
    mq.reset_launch_counts()
    first = probe(init, 12)
    edge, info = train_neural_bp(
        w1944, llrs, np.zeros(llrs.shape, np.int8),
        TrainConfig(learning_rate=r["lr"], num_epochs=r["epochs"],
                    batch_size=r["batch"], eval_every=1),
        probe_snr_db=(2.0, 2.5), probe_batch=batch, device="cuda",
        log=lambda m: print("  " + m, flush=True), **lay6)
    counts = {k: v for k, v in mq.LAUNCHES.items() if v}
    n_probe = 2 * (1 + len(info["probe"]))
    print(f"  train_neural_bp: {len(info['loss'])} steps and "
          f"{len(info['probe']) + 1} probes in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts} [{card}]",
          flush=True)
    if counts != {"minsum_qc_layered_w": n_probe}:
        fail(f"train_neural_bp: launches {counts}, expected "
             f"minsum_qc_layered_w {n_probe} times (each probe decode) and "
             "nothing else")
    if not all(math.isfinite(v) for v in info["loss"]):
        fail(f"train_neural_bp: non-finite BCE {info['loss']}")
    out["probe_launches"] = n_probe
    out["edge"] = edge
    gen = torch.Generator(device="cuda").manual_seed(13)
    for snrdb, ber in first.items():
        bits = bp_decode(floor_llrs(w1944, batch, snrdb, gen), w1944,
                         iterations=6, schedule="layered")
        e = bits.sum(1, dtype=torch.int64).double()
        plain = float(e.mean()) / w1944.n
        tol = 4 * math.sqrt(2) * float(e.std()) / (
            math.sqrt(batch) * w1944.n)
        print(f"  first probe @ {snrdb:g} dB (all-ones weights, "
              f"minsum_qc_layered_w): BER {ber!r} against plain layered-6 "
              f"{plain!r} (4 sigma {tol!r}); last probe "
              f"{info['probe'][-1]['ber'][snrdb]!r} [{card}]", flush=True)
        if abs(ber - plain) > tol:
            fail(f"the first probe @ {snrdb:g} dB: BER {ber} is not within "
                 f"4 sigma ({tol}) of plain layered-6's {plain}")

    # (c) train_llr at the CLI's defaults on the card and on the CPU, from
    # one dataset and one CPU-drawn initialisation
    t0 = time.perf_counter()
    ref = get_code("ref6432")
    x, y = make_llr_dataset(torch.Generator(device="cuda").manual_seed(0),
                            ref, LinkConfig(bp_iterations=1), 4096,
                            snrdb=5.0)
    tc = TrainConfig()
    t1 = time.perf_counter()
    m_card, i_card = train_llr(LLRestimator(32), x, y, tc, log=None,
                               device="cuda")
    t_card = time.perf_counter() - t1
    t1 = time.perf_counter()
    m_cpu, i_cpu = train_llr(LLRestimator(32), x, y, tc, log=None,
                             device="cpu")
    t_cpu = time.perf_counter() - t1
    worst = 0.0
    for (k, a), b in zip(m_card.state_dict().items(),
                         m_cpu.state_dict().values()):
        d = float((a.cpu() - b).abs().max()) / float(b.abs().max())
        worst = max(worst, d)
    lc, lg = np.asarray(i_cpu["train_loss"]), np.asarray(i_card["train_loss"])
    rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    print(f"  train_llr (ref6432, 4096 codewords, 100 epochs, batch 4096, "
          f"sgd 0.01): card {t_card:.2f} s, CPU {t_cpu:.2f} s; loss "
          f"{float(lg[0])!r} -> {float(lg[-1])!r}; params card against CPU "
          f"within "
          f"{worst!r} of max|param|, losses within {rel!r} relative "
          f"[{card}]", flush=True)
    if worst > 1e-3 or rel > 1e-4:
        fail(f"train_llr card against CPU: params {worst} (limit 1e-3 of "
             f"max|param|), losses {rel} (limit 1e-4 relative)")
    runs = os.path.join(tmp, "llr")
    cli_main(["train-llr", "--out", runs])
    cli_main(["generate-data", "--out", runs])
    if not any(f.endswith("_data.npz") for f in os.listdir(runs)):
        fail("generate-data wrote no dataset")
    if load_checkpoint(load_runs(runs)[-1]["ckpt"])[1].get(
            "model") != "LLRestimator":
        fail("train-llr's checkpoint manifest does not name its model")
    print(f"  (c) took {time.perf_counter() - t0:.1f} s", flush=True)

    # (d) train-joint as the before/after study ran it, a few epochs
    t0 = time.perf_counter()
    runs = os.path.join(tmp, "joint")
    cli_main(JOINT_TRAIN_FLAGS + ["--out", runs])
    tree, mani = load_checkpoint(load_runs(runs)[-1]["ckpt"])
    hold = mani["holdout"]
    if not (all(math.isfinite(v) for v in mani["train_loss"]) and hold
            and all(math.isfinite(h["ber"]) and math.isfinite(h["loss"])
                    for h in hold)):
        fail(f"train-joint: non-finite loss or holdout BER: "
             f"{mani['train_loss']}, {hold}")
    keys = _key_tree(tree)
    dense = {"kernel": "float32", "bias": "float32"}
    llr_tree = {"fft_layer": {"kernel": "float32"}, "hidden3": dense,
                "hidden4": dense, "hidden5": dense, "final": dense}
    bp = {f"bp_w_{k}": "float32"
          for k in ("llr", "llr_final", "msg", "msg_final")}
    params = {"LLRest": llr_tree, **bp}

    def adam(masked):
        moments = {k: ({} if k in masked else v) for k, v in params.items()}
        return {"inner_state": {"0": {"count": "int32",
                                      "mu": {"params": moments},
                                      "nu": {"params": moments}},
                                "1": {}}}

    # flax's serialization of optax.multi_transform over two adams, the
    # llr label on LLRest and the bp label on the rest (masked nodes {})
    want = {"params": {"params": params}, "opt_state": {"inner_states": {
        "bp": adam({"LLRest"}), "llr": adam(set(bp))}}}
    if keys != want:
        fail(f"train-joint's checkpoint key tree is not JAX's: {keys}")
    shape = tuple(tree["params"]["params"]["bp_w_msg"].shape)
    print(f"  train-joint (ref6432, 3-bit ADC, 3 iterations, adam 2e-5, "
          f"batch 2048): losses {mani['train_loss']}, holdout {hold}; "
          f"checkpoint in JAX's key tree (bp_w_msg {shape}) in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, ROOT)
    try:
        import ldpc_sims_tpu_torch
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    if os.path.dirname(os.path.dirname(
            os.path.abspath(ldpc_sims_tpu_torch.__file__))) != ROOT:
        fail(f"imported {ldpc_sims_tpu_torch.__file__}, not this checkout's")

    from ldpc_sims_tpu_torch.cli.main import (
        PRESETS,
        build_parser,
        sweep_configs,
    )
    from ldpc_sims_tpu_torch.codes import get_code, make_regular_ldpc
    from ldpc_sims_tpu_torch.convert import load_trained_schedule
    from ldpc_sims_tpu_torch.kernels import minsum_qc as mq
    from ldpc_sims_tpu_torch.kernels.compare import floor_llrs
    from ldpc_sims_tpu_torch.ops.bp_roll import decode_roll, qc_plan
    from ldpc_sims_tpu_torch.ops import bp_decode, pack_decoder_weights
    from ldpc_sims_tpu_torch.ops.chain import LinkConfig
    from ldpc_sims_tpu_torch.parallel import SweepConfig, mc_step
    from ldpc_sims_tpu_torch.utils import load_decoder_weights

    # the message storage types beside f32 and their row suffixes
    storage_rows = {torch.bfloat16: "bf16", torch.int8: "int8"}
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # -- phase 1: build and identify -------------------------------------
    print("== phase 1: build and identify", flush=True)
    t0 = time.perf_counter()
    lib, report = mq.build()
    mq._library()  # load it now, so a bad build fails here
    edge_probe = start_edge_probe()  # phase 4's SASS probe, in the background
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in report.splitlines():
        if ("registers" in line or "Compiling entry" in line or "spill" in line
                or line.startswith("# nvcc")):
            print("  " + line.strip(), flush=True)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    # the sum-product kernels with a check's slots in registers, the
    # group-serial kernels and the min-sum kernels on the wide word: no
    # slot indexed at run time, so no stack frame
    for sfx in ("_sr", "_gs", "_cw"):
        ks = {k: v for k, v in ptxas_entries(report).items() if sfx in k}
        for k, (stack, regs) in sorted(ks.items()):
            print(f"  {k}: {stack} B stack frame, {regs} registers",
                  flush=True)
        if len(ks) != 36 or any(stack != 0 for stack, _ in ks.values()):
            fail(f"the 36 {sfx} kernels need 0 B stack frames: {ks}")
    # the sum-product and group-serial kernels on the wide rows: a body of
    # up to 18 slots a check in registers; a stack frame is allowed where
    # the kernel beats the full-message one (phase 4)
    wide_stack = {}
    for sfx, built in (("_rw", 18), ("_gw", 36), ("_lw", 18)):
        ks = {k: v for k, v in ptxas_entries(report).items() if sfx in k}
        for k, (stack, regs) in sorted(ks.items()):
            print(f"  {k}: {stack} B stack frame, {regs} registers",
                  flush=True)
            wide_stack[k.split("P")[0].lstrip("_Z0123456789")] = stack
        if len(ks) != built:
            fail(f"the {built} {sfx} kernels were not all built: "
                 f"{sorted(ks)}")

    # -- phase 2: kernels vs plain versions on the card --------------------
    print("== phase 2: kernels vs plain versions (batch 4096)", flush=True)
    w1944, w648 = get_code("wifi1944"), get_code("wifi648")
    a8, b8 = load_trained_schedule(SCHEDULES, "wifi1944", 8)
    cases = [
        ("minsum_qc_flooding", w1944, dict(
            iterations=20, schedule="flooding"), "wifi1944 flooding-20"),
        ("minsum_qc_flooding", w1944, dict(
            iterations=20, schedule="flooding", alpha=0.75, beta=0.1,
            clamp=20.0), "wifi1944 flooding-20 a=0.75 b=0.1 clamp 20"),
        ("minsum_qc_layered", w1944, dict(
            iterations=8, schedule="layered", alpha=a8, beta=b8),
         "wifi1944 trained layered-8"),
        ("minsum_qc_flooding", w648, dict(
            iterations=20, schedule="flooding"), "wifi648 flooding-20"),
    ]
    max_err = {name: 0.0 for name in (
        *mq.LAUNCHES, ES_AUTO_ROW, MSGQ_ROW, G4_ROW, EVAL_ROW,
        TRAIN_MINSUM_ROW, TRAIN_PROBE_ROW, GRID_ROW, DE_ROW,
        *(r for r, _ in FLOOR_ROWS.values()),
        *(r for _, r in EXAMPLE_ROWS.values()), *WIDE_ROWS, *LW_ROWS,
        *(f"{k}@wifi648" for k in SP_KERNELS))}
    for name, code, kw, tag in cases:
        llr = channel_llrs(code, 4096, 1.5, seed=len(tag))
        k_post = mq.bp_qc_cuda(llr, code.qc, output="posterior", **kw)
        k_bits = mq.bp_qc_cuda(llr, code.qc, output="hard", **kw)
        p_post = decode_roll(llr, code.qc, output="posterior", **kw)
        torch.cuda.synchronize()
        max_err[name] = max(max_err[name], compare(k_post, p_post, tag))
        if not torch.equal(k_bits, (k_post > 0).to(torch.int8)):
            fail(f"hard output disagrees with the posterior's signs: {tag}")

    print("== phase 2b: early-stop forms vs plain versions (batch 4096)",
          flush=True)
    B = 4096
    for code in (w1944, w648):
        qc = code.qc
        for snrdb in (1.5, 3.0):
            at = f"{code.name} @ {snrdb:g} dB"
            llr = channel_llrs(code, B, snrdb, seed=int(snrdb * 10))
            # fixed decode + unsatisfied-check count
            for sched, iters in (("flooding", 20), ("layered", 4)):
                kw = dict(iterations=iters, schedule=sched,
                          output="hard_unsat")
                kb, ku = mq.bp_qc_cuda(llr, qc, **kw)
                pb, pu = decode_roll(llr, qc, **kw)
                exact([(kb, pb), (ku, pu), (ku, external_unsat(kb, code))],
                      f"{at} {sched}-{iters} hard_unsat")
                print(f"  {at} {sched}-{iters} hard_unsat: bits and counts "
                      f"equal, = bits·Hᵀ mod 2; {int((ku == 0).sum())} of "
                      f"{B} satisfied", flush=True)
            # early stop, K = 1 and 2
            for sched in ("flooding", "layered"):
                for K in (1, 2):
                    kw = dict(iterations=20, schedule=sched,
                              output="hard_iters", early_stop=True,
                              es_check_every=K)
                    kb, ki = mq.bp_qc_cuda(llr, qc, **kw)
                    pb, pi = decode_roll(llr, qc, **kw)
                    name = mq.KERNELS["min-sum", sched, True, False]
                    max_err[name] = max(max_err[name], exact(
                        [(kb, pb), (ki, pi)], f"{at} {sched}-20 ES K={K}"))
                    print(f"  {at} {sched}-20 early stop K={K}: bits and "
                          f"iterations equal; mean iterations "
                          f"{float(ki.float().mean()):.3f}, "
                          f"{int((ki == 20).sum())} at the budget",
                          flush=True)
            # done_in: about half the codewords flagged
            gen = torch.Generator(device="cuda")
            gen.manual_seed(int(snrdb * 100))
            mask = torch.rand(B, generator=gen, device="cuda") < 0.5
            for es in (False, True):
                kw = dict(iterations=20, schedule="layered", early_stop=es,
                          output="hard_iters" if es else "hard")
                sentinel = torch.full(llr.shape, 7, dtype=torch.int8,
                                      device="cuda")
                got = mq.bp_qc_cuda(llr, qc, done_in=mask, out=sentinel,
                                    **kw)
                want = decode_roll(llr, qc, done_in=mask, **kw)
                kb, pb = (got[0], want[0]) if es else (got, want)
                pairs = [(kb[~mask], pb[~mask])]
                if es:
                    pairs.append((got[1], want[1]))
                exact(pairs, f"{at} layered-20 done_in (es={es})")
                if not bool((kb[mask] == 7).all()):
                    fail(f"{at}: done_in rows were written (es={es})")
                print(f"  {at} layered-20 done_in (early stop {es}): "
                      f"{int(mask.sum())} flagged rows untouched, the rest "
                      "equal", flush=True)
            # the drivers against plain compositions of their steps
            rb, ri = mq.bp_qc_requeue(llr, qc, 20, probe_iters=4,
                                      es_check_every=2, schedule="layered",
                                      output="hard_iters")
            es_kw = dict(schedule="layered", output="hard_iters",
                         early_stop=True, es_check_every=2)
            b1, i1 = decode_roll(llr, qc, iterations=4, **es_kw)
            b2, i2 = decode_roll(llr, qc, iterations=20, **es_kw)
            done = i1 < 4
            exact([(rb, torch.where(done[:, None], b1, b2)),
                   (ri, torch.where(done, i1, 4 + i2))],
                  f"{at} bp_qc_requeue")
            pb_, pi_ = mq.bp_qc_probe_requeue(llr, qc, 20, probe_iters=4,
                                              output="hard_iters")
            b1, u1 = decode_roll(llr, qc, iterations=4, schedule="layered",
                                 output="hard_unsat")
            b2 = decode_roll(llr, qc, iterations=20, schedule="layered")
            done = u1 == 0
            over = B - int(done.sum()) > mq.probe_capacity(B)
            keep = done & (not over)
            exact([(pb_, torch.where(keep[:, None], b1, b2)),
                   (pi_, torch.where(keep, 4, 24).to(torch.int32))],
                  f"{at} bp_qc_probe_requeue")
            print(f"  {at} drivers: requeue ({int((ri > 4).sum())} "
                  f"re-decoded) and probe ({B - int(done.sum())} "
                  f"stragglers, overflow {over}) equal", flush=True)
    llr = channel_llrs(w648, B, 0.0, seed=5)
    pb_, pi_ = mq.bp_qc_probe_requeue(llr, w648.qc, 20, probe_iters=4,
                                      output="hard_iters")
    exact([(pb_, decode_roll(llr, w648.qc, iterations=20,
                             schedule="layered"))],
          "wifi648 @ 0 dB probe overflow")
    if not bool((pi_ == 24).all()):
        fail("wifi648 @ 0 dB: the probe driver did not take its overflow "
             "branch")
    print("  wifi648 @ 0 dB probe overflow: every codeword re-decoded at "
          "the full budget, bits equal", flush=True)

    print("== phase 2c: sum-product and quantized forms vs plain versions "
          "(batch 4096)", flush=True)
    rules = (("sum-product", None), ("min-sum", 4), ("sum-product", 4))
    for code in (w1944, w648):
        qc = code.qc
        llr = channel_llrs(code, B, 1.5, seed=21)
        # saturated rows: |LLR| = 60 with the channel's signs
        llr[:64] = torch.where(llr[:64] > 0, 60.0, -60.0)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(22)
        mask = torch.rand(B, generator=gen, device="cuda") < 0.5
        for method, qb in rules:
            for sched in ("flooding", "layered"):
                at = f"{code.name} {sched} {method} msg_qbits={qb}"
                kw = dict(schedule=sched, method=method, msg_qbits=qb)
                name = mq.KERNELS[method, sched, False, qb is not None]
                fixed = dict(iterations=10, **kw)
                kp = mq.bp_qc_cuda(llr, qc, output="posterior", **fixed)
                pp = decode_roll(llr, qc, output="posterior", **fixed)
                torch.cuda.synchronize()
                max_err[name] = max(max_err[name],
                                    compare(kp, pp, f"{at} posterior"))
                kb, ku = mq.bp_qc_cuda(llr, qc, output="hard_unsat", **fixed)
                pb, pu = decode_roll(llr, qc, output="hard_unsat", **fixed)
                exact([(kb, pb), (ku, pu), (kb, (kp > 0).to(torch.int8)),
                       (ku, external_unsat(kb, code))], f"{at} hard_unsat")
                es = dict(iterations=20, early_stop=True, es_check_every=1,
                          output="hard_iters", **kw)
                kb, ki = mq.bp_qc_cuda(llr, qc, **es)
                pb, pi = decode_roll(llr, qc, **es)
                es_name = mq.KERNELS[method, sched, True, qb is not None]
                max_err[es_name] = max(max_err[es_name], exact(
                    [(kb, pb), (ki, pi)], f"{at} early stop"))
                sentinel = torch.full(llr.shape, 7, dtype=torch.int8,
                                      device="cuda")
                mq.bp_qc_cuda(llr, qc, done_in=mask, out=sentinel, **fixed)
                pb = decode_roll(llr, qc, done_in=mask, **fixed)
                exact([(sentinel[~mask], pb[~mask])], f"{at} done_in")
                if not bool((sentinel[mask] == 7).all()):
                    fail(f"{at}: done_in rows were written")
                print(f"  {at}: bits, counts (= bits·Hᵀ mod 2), early-stop "
                      f"bits and iterations (mean "
                      f"{float(ki.float().mean()):.3f}) and done_in equal",
                      flush=True)
        # both drivers with sum-product
        sp = dict(method="sum-product", schedule="layered")
        rb, ri = mq.bp_qc_requeue(llr, qc, 20, probe_iters=4,
                                  es_check_every=2, output="hard_iters", **sp)
        es = dict(early_stop=True, es_check_every=2, output="hard_iters",
                  **sp)
        b1, i1 = decode_roll(llr, qc, iterations=4, **es)
        b2, i2 = decode_roll(llr, qc, iterations=20, **es)
        done = i1 < 4
        exact([(rb, torch.where(done[:, None], b1, b2)),
               (ri, torch.where(done, i1, 4 + i2))],
              f"{code.name} sum-product bp_qc_requeue")
        pb_, pi_ = mq.bp_qc_probe_requeue(llr, qc, 20, probe_iters=4,
                                          output="hard_iters", **sp)
        b1, u1 = decode_roll(llr, qc, iterations=4, output="hard_unsat", **sp)
        b2 = decode_roll(llr, qc, iterations=20, **sp)
        keep = (u1 == 0) & (B - int((u1 == 0).sum()) <= mq.probe_capacity(B))
        exact([(pb_, torch.where(keep[:, None], b1, b2)),
               (pi_, torch.where(keep, 4, 24).to(torch.int32))],
              f"{code.name} sum-product bp_qc_probe_requeue")
        print(f"  {code.name} sum-product drivers: requeue and probe equal",
              flush=True)

    print("== phase 2d: weighted and group-serial forms vs plain versions "
          "(batch 4096)", flush=True)
    for code in (w1944, w648):
        qc = code.qc
        llr = channel_llrs(code, B, 1.5, seed=31)
        w = random_edge_weights(code, 6, seed=32)
        for method, qb in (("min-sum", None), *rules):
            for sched in ("flooding", "layered"):
                at = f"{code.name} {sched}-6 {method} msg_qbits={qb} weighted"
                kw = dict(iterations=6, schedule=sched, method=method,
                          msg_qbits=qb, weights=w)
                name = mq.KERNELS_W[method, sched, qb is not None]
                kp = mq.bp_qc_cuda(llr, qc, output="posterior", **kw)
                pp = decode_roll(llr, qc, output="posterior", **kw)
                torch.cuda.synchronize()
                max_err[name] = max(max_err[name], compare(kp, pp, at))
                kb, ku = mq.bp_qc_cuda(llr, qc, output="hard_unsat", **kw)
                pb, pu = decode_roll(llr, qc, output="hard_unsat", **kw)
                exact([(kb, pb), (ku, pu), (kb, (kp > 0).to(torch.int8))],
                      f"{at} hard_unsat")
        # group-serial layered on the _gs kernels: min-sum and
        # sum-product, and min-sum's early-stop form, against the plain
        # version, exactly, with 64 rows saturated at |LLR| = 60
        sat = llr.clone()
        sat[:64] = torch.where(sat[:64] > 0, 60.0, -60.0)
        for method in ("min-sum", "sum-product"):
            for G in (2, 3, 4, qc.mb):
                at = f"{code.name} layered-6 {method} G={G}"
                kw = dict(iterations=6, schedule="layered", method=method,
                          layered_group=G)
                name = mq.KERNELS[method, "layered", False, False]
                entry = mq.entry_point(qc, method, "layered",
                                       layered_group=G)
                if not entry.endswith("_gs"):
                    fail(f"{at}: launches {entry}")
                kp = mq.bp_qc_cuda(sat, qc, output="posterior", **kw)
                pp = decode_roll(sat, qc, output="posterior", **kw)
                max_err[name] = max(max_err[name], exact(
                    [(kp, pp), (mq.bp_qc_cuda(sat, qc, **kw),
                                (pp > 0).to(torch.int8))], at))
            print(f"  {code.name} layered-6 {method} G = 2, 3, 4, {qc.mb} "
                  f"({entry}): posteriors and bits equal", flush=True)
        kw = dict(iterations=20, schedule="layered", layered_group=3,
                  early_stop=True, output="hard_iters")
        kb, ki = mq.bp_qc_cuda(llr, qc, **kw)
        pb, pi = decode_roll(llr, qc, **kw)
        exact([(kb, pb), (ki, pi)], f"{code.name} layered-20 G=3 early stop")
        print(f"  {code.name} layered-20 G=3 early stop: bits and iterations "
              f"equal, mean iterations {float(ki.float().mean()):.3f}",
              flush=True)
        # the ends of the family: G = 1 is the serial-C kernel bit for bit,
        # G = mb is flooding up to the order of the sums
        kw = dict(iterations=6, output="posterior")
        g1 = mq.bp_qc_cuda(llr, qc, schedule="layered", layered_group=1, **kw)
        if not (torch.equal(g1, mq.bp_qc_cuda(llr, qc, schedule="layered",
                                              **kw))
                and torch.equal(g1, decode_roll(llr, qc, schedule="layered",
                                                **kw))):
            fail(f"{code.name}: G = 1 is not the serial-C decode bit for bit")
        gmb = mq.bp_qc_cuda(llr, qc, schedule="layered",
                            layered_group=qc.mb, iterations=4,
                            output="posterior")
        flood = mq.bp_qc_cuda(llr, qc, iterations=4, output="posterior")
        diff = (gmb - flood).abs()
        off = (diff > TOL + TOL * flood.abs()).any(dim=1)
        print(f"  {code.name} G=1: equal to the serial-C kernel and plain "
              f"version; G=mb 4 iterations against flooding-4: max |diff| "
              f"{float(diff.max()):.3e}, {int(off.sum())} of {B} codewords "
              f"beyond {TOL:g}", flush=True)
        # a v2c within an ulp of 0 can flip a check's sign parity, which
        # the other order of the sums may decide the other way: allow a
        # rare codeword
        if int(off.sum()) > B // 1000:
            fail(f"{code.name}: G = mb is not flooding within {TOL:g}")
    # the committed K6 decoder: its ms arrays as the kernel's α/β table
    k6 = load_decoder_weights(K6_NPZ)
    k6_edge = {k: v for k, v in k6.items() if k.startswith("w_")}
    a6 = tuple(float(x) for x in k6["ms_alpha"])
    b6 = tuple(float(x) for x in k6["ms_beta"])
    llr = channel_llrs(w1944, B, 1.5, seed=33)
    kw = dict(iterations=6, schedule="layered", output="posterior")
    kp = bp_decode(llr, w1944, weights=k6, **kw)
    pp = decode_roll(llr, w1944.qc, alpha=a6, beta=b6, weights=k6_edge, **kw)
    torch.cuda.synchronize()
    max_err["minsum_qc_layered_w"] = max(max_err["minsum_qc_layered_w"],
                                         compare(kp, pp, "wifi1944 K6 npz"))

    print("== phase 2e: bf16 and int8 message storage vs plain versions "
          "(batch 4096)", flush=True)
    for code in (w1944, w648):
        qc = code.qc
        llr = channel_llrs(code, B, 1.5, seed=51)
        llr[:64] = torch.where(llr[:64] > 0, 60.0, -60.0)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(52)
        mask = torch.rand(B, generator=gen, device="cuda") < 0.5
        w = random_edge_weights(code, 6, seed=53)
        for dt, sfx in storage_rows.items():
            # int8 on the bigcode run's grid (±24); the 4-bit forms take
            # ±20 for both grids, as the quantized-minsum preset
            st = dict(dtype=dt, msg_qclip=24.0)
            for method, qb in (("min-sum", None), *rules):
                for sched in ("flooding", "layered"):
                    at = f"{code.name} {sched} {method} msg_qbits={qb} {sfx}"
                    kw = dict(schedule=sched, method=method, msg_qbits=qb,
                              **st)
                    if qb is not None:
                        kw["msg_qclip"] = 20.0
                    fixed = dict(iterations=10, **kw)
                    name = mq.kernel_name(method, sched, False,
                                          qb is not None, dtype=dt)
                    kp = mq.bp_qc_cuda(llr, qc, output="posterior", **fixed)
                    pp = decode_roll(llr, qc, output="posterior", **fixed)
                    kb, ku = mq.bp_qc_cuda(llr, qc, output="hard_unsat",
                                           **fixed)
                    pb, pu = decode_roll(llr, qc, output="hard_unsat",
                                         **fixed)
                    max_err[name] = max(max_err[name], exact(
                        [(kp, pp), (kb, pb), (ku, pu),
                         (kb, (kp > 0).to(torch.int8))], f"{at} fixed"))
                    es = dict(iterations=20, early_stop=True,
                              es_check_every=2, output="hard_iters", **kw)
                    kb, ki = mq.bp_qc_cuda(llr, qc, **es)
                    pb, pi = decode_roll(llr, qc, **es)
                    es_name = mq.kernel_name(method, sched, True,
                                             qb is not None, dtype=dt)
                    max_err[es_name] = max(max_err[es_name], exact(
                        [(kb, pb), (ki, pi)], f"{at} early stop"))
                    sentinel = torch.full(llr.shape, 7, dtype=torch.int8,
                                          device="cuda")
                    mq.bp_qc_cuda(llr, qc, done_in=mask, out=sentinel,
                                  **fixed)
                    pb = decode_roll(llr, qc, done_in=mask, **fixed)
                    exact([(sentinel[~mask], pb[~mask])], f"{at} done_in")
                    if not bool((sentinel[mask] == 7).all()):
                        fail(f"{at}: done_in rows were written")
                    kw6 = dict(kw, iterations=6, weights=w,
                               output="posterior")
                    w_name = mq.kernel_name(method, sched, False,
                                            qb is not None, True, dt)
                    max_err[w_name] = max(max_err[w_name], exact(
                        [(mq.bp_qc_cuda(llr, qc, **kw6),
                          decode_roll(llr, qc, **kw6))], f"{at} weighted"))
                    if sched == "layered":
                        for G in (2, 3, 4, qc.mb):
                            gk = dict(fixed, layered_group=G,
                                      output="posterior")
                            max_err[name] = max(max_err[name], exact(
                                [(mq.bp_qc_cuda(llr, qc, **gk),
                                  decode_roll(llr, qc, **gk))],
                                f"{at} G={G}"))
                    print(f"  {at}: posterior, bits, counts, early stop "
                          f"(mean {float(ki.float().mean()):.3f} "
                          "iterations), done_in, weighted"
                          + (f", G = 2, 3, 4, {qc.mb}"
                             if sched == "layered" else "")
                          + " equal", flush=True)
            # both drivers
            es = dict(schedule="layered", early_stop=True, es_check_every=2,
                      output="hard_iters", **st)
            rb, ri = mq.bp_qc_requeue(llr, qc, 20, probe_iters=4,
                                      es_check_every=2, output="hard_iters",
                                      schedule="layered", **st)
            b1, i1 = decode_roll(llr, qc, iterations=4, **es)
            b2, i2 = decode_roll(llr, qc, iterations=20, **es)
            done = i1 < 4
            exact([(rb, torch.where(done[:, None], b1, b2)),
                   (ri, torch.where(done, i1, 4 + i2))],
                  f"{code.name} {sfx} bp_qc_requeue")
            pb_, pi_ = mq.bp_qc_probe_requeue(llr, qc, 20, probe_iters=4,
                                              output="hard_iters", **st)
            b1, u1 = decode_roll(llr, qc, iterations=4, schedule="layered",
                                 output="hard_unsat", **st)
            b2 = decode_roll(llr, qc, iterations=20, schedule="layered",
                             **st)
            keep = (u1 == 0) & (B - int((u1 == 0).sum())
                                <= mq.probe_capacity(B))
            exact([(pb_, torch.where(keep[:, None], b1, b2)),
                   (pi_, torch.where(keep, 4, 24).to(torch.int32))],
                  f"{code.name} {sfx} bp_qc_probe_requeue")
            print(f"  {code.name} {sfx} drivers: requeue and probe equal",
                  flush=True)
    big = get_code("qc12288_r12")
    llr = channel_llrs(big, 256, 1.75, seed=54)
    for dt, sfx in {torch.float32: "f32", **storage_rows}.items():
        kw = dict(iterations=10, schedule="layered", output="posterior",
                  dtype=dt, msg_qclip=24.0)
        name = mq.kernel_name("min-sum", "layered", dtype=dt)
        max_err[name] = max(max_err[name], exact(
            [(mq.bp_qc_cuda(llr, big.qc, **kw),
              decode_roll(llr, big.qc, **kw))], f"qc12288 layered-10 {sfx}"))
        print(f"  qc12288_r12 layered-10 {sfx} (batch 256, "
              f"{mq.smem_bytes(big.qc, 1, dt, 'min-sum', 'layered')} B of "
              "shared memory a codeword): posterior equal", flush=True)

    # -- phase 2f: adversarial input for the compressed check state ------
    print("== phase 2f: every serial-C, group-serial and flooding min-sum "
          "form on integer LLRs vs plain versions", flush=True)
    # rows of degree 8-9, 11-12, 17-18: the wide word's _cw kernels (G =
    # 1) and _gw kernels (G > 1); a row of degree 10: full messages
    t2f = time.perf_counter()
    r23, r34 = get_code("qc1944_r23"), get_code("qc1944_r34")
    wide = [get_code(c) for c in ("qc648_r23", "qc648_r56")] + [
        r23, get_code("qc1944_r56")]
    wide_g = [wide[0], wide[1], r34, wide[3]]
    d10 = degree10_code()
    adversarial("layered", [(c, (1, 2, 3, 4, c.qc.mb)) for c in (w1944, w648)]
                + [(c, (1,)) for c in wide]
                + [(c, sorted({2, 3, 4, c.qc.mb})) for c in wide_g]
                + [(d10, (4,))], storage_rows, max_err)
    adversarial("flooding", [(c, (1,)) for c in (
        w1944, w648, get_code("qc8448_r12"), *wide)], storage_rows, max_err)
    print(f"  phase 2f took {time.perf_counter() - t2f:.1f} s", flush=True)

    # -- phase 2g: sum-product with a check's slots in registers -----------
    print("== phase 2g: every sum-product form on the kernels with a check's "
          "slots in registers, serial-C, flooding and group-serial, on the "
          "wide rows' flooding kernels with one lt an edge (and on the "
          "full-message kernels a code beyond the limits keeps) vs plain "
          "versions", flush=True)
    t2g = time.perf_counter()
    sumproduct_registers(
        [(c, 1, "_sr") for c in (w1944, w648, get_code("qc8448_r12"))]
        + [(c, G, "_gs") for c in (w1944, w648) for G in (2, 3, 4, c.qc.mb)]
        + [(c, 1, {"flooding": "_lw", "layered": "_rw"}) for c in wide_g]
        + [(get_code(c), 1, {"flooding": "_lw"})
           for c in ("qc648_r34", "qc1944_r23")]
        + [(c, G, "_gw") for c in wide_g for G in sorted({2, 4, c.qc.mb})]
        + [(d10, 1, ""), (d10, 2, "")], storage_rows, max_err)
    print(f"  phase 2g took {time.perf_counter() - t2g:.1f} s", flush=True)

    # -- phase 3: the main path at full width -----------------------------
    print("== phase 3: run_sweep at wifi1944, QPSK, OFDM-32, batch 32768",
          flush=True)
    batch = 32768
    steps_per_point = 4
    sweep = SweepConfig(
        snrdb=(1.5, 2.0), batch_cw=batch, target_frame_errors=10**12,
        max_info_bits=steps_per_point * batch * w1944.k, seed=0,
    )
    configs = {
        "flooding-20": (LinkConfig(bp_iterations=20, bp_method="min-sum",
                                   clamp=None), "minsum_qc_flooding"),
        "trained layered-8": (LinkConfig(
            bp_iterations=8, bp_method="min-sum", clamp=None,
            bp_schedule="layered", alpha=a8, beta=b8), "minsum_qc_layered"),
    }
    launches, per_step, main_res = {}, {}, {}
    for label, (cfg, kname) in configs.items():
        res, counts, ev, rate = drive(label, w1944, cfg, sweep, [kname], card)
        main_res[label] = (res, rate)
        launches[kname] = counts[kname]
        per_step[kname] = counts[kname] / ev.mc_steps
        if not res.coded_bler[1] < res.coded_bler[0]:
            fail(f"{label}: BLER does not fall from 1.5 to 2.0 dB")
        profile_step(mc_step(w1944, cfg, batch, device="cuda"), label, card)
    # flooding-20 on its artifact's channel, 8 x 32768 codewords a point:
    # within 4σ, σ from this run's per-codeword counts and the artifact's
    # (the same per-codeword spread over its 987,365,376 info bits)
    for snrdb, ref in FLOODING20_BER.items():
        ber, se = info_ber(w1944, snrdb, 8, batch, seed=43, iterations=20)
        sig = se * math.sqrt(1 + 8 * batch * w1944.k / FLOODING20_BITS)
        print(f"  flooding-20 on the artifact's channel @ {snrdb:g} dB: "
              f"info-bit BER {ber!r} against {ref!r}, 4σ = {4 * sig!r} "
              f"[{card}]", flush=True)
        if not abs(ber - ref) <= 4 * sig:
            fail(f"flooding-20 @ {snrdb:g} dB: BER {ber} not within 4σ of "
                 f"the artifact's {ref}")

    # the early-stop path: es_mode='auto' chooses per point
    es_cfg = LinkConfig(bp_iterations=20, bp_method="min-sum", clamp=None,
                        bp_schedule="layered", early_stop=True,
                        es_mode="auto", es_probe_iters=4)
    es_sweep = dataclasses.replace(
        sweep, snrdb=(2.5, 3.5), max_info_bits=6 * batch * w1944.k)
    res, counts, ev, _ = drive("layered-20 es auto", w1944, es_cfg,
                               es_sweep, ["minsum_qc_layered"], card)
    # the layered kernel's launches on this path (fixed chunks: one full
    # pass; probe chunks: the hard_unsat probe and the done_in pass), a
    # row of their own beside the trained layered-8 path's
    launches[ES_AUTO_ROW] = counts["minsum_qc_layered"]
    per_step[ES_AUTO_ROW] = counts["minsum_qc_layered"] / ev.mc_steps
    if len(ev.auto) != 2:
        fail("es auto: expected one calibration per point")
    # strictly lower where the lower SNR saw frame errors at all
    lo, hi = res.coded_bler
    if not (hi < lo or hi == lo == 0.0):
        fail("layered-20 es auto: BLER does not fall from 2.5 to 3.5 dB")
    for mode in ("freeze", "probe"):
        cfg = dataclasses.replace(
            es_cfg, early_stop=mode == "probe", es_mode=mode)
        profile_step(mc_step(w1944, cfg, batch, device="cuda"),
                     f"layered-20 {'fixed' if mode == 'freeze' else mode}",
                     card, snrdb=2.5)
    one = dataclasses.replace(sweep, snrdb=(3.5,))
    for mode, kname in (("probe", "minsum_qc_layered"),
                        ("requeue", "minsum_qc_layered_es")):
        _, counts, ev, _ = drive(
            f"layered-20 es {mode}", w1944,
            dataclasses.replace(es_cfg, es_mode=mode), one, [kname], card)
        if mode == "requeue":
            launches[kname] = counts[kname]
            per_step[kname] = counts[kname] / ev.mc_steps
    _, counts, ev, _ = drive(
        "flooding-20 es freeze", w1944,
        LinkConfig(bp_iterations=20, bp_method="min-sum", clamp=None,
                   early_stop=True),
        dataclasses.replace(sweep, snrdb=(2.0,)),
        ["minsum_qc_flooding_es"], card)
    launches["minsum_qc_flooding_es"] = counts["minsum_qc_flooding_es"]
    per_step["minsum_qc_flooding_es"] = (counts["minsum_qc_flooding_es"]
                                         / ev.mc_steps)

    # the probe rescues no worse than the fixed decode, on one batch at
    # 3.0 dB, where the stragglers fit the capacity (the compact path)
    llr30, coded30 = channel_llrs(w1944, batch, 3.0, seed=11,
                                  with_coded=True)
    bits_p, it_p = mq.bp_qc_probe_requeue(llr30, w1944.qc, 20, probe_iters=4,
                                          output="hard_iters")
    bits_f = mq.bp_qc_cuda(llr30, w1944.qc, 20, schedule="layered")
    strag = it_p > 4
    n_strag = int(strag.sum())
    if not 0 < n_strag <= mq.probe_capacity(batch):
        fail(f"shared batch @ 3 dB: {n_strag} stragglers, not the compact "
             "path")
    exact([(bits_p[strag], bits_f[strag])], "probe stragglers vs fixed")
    err_p = int((bits_p != coded30).sum())
    err_f = int((bits_f != coded30).sum())
    print(f"  shared batch @ 3 dB: {n_strag} stragglers (capacity "
          f"{mq.probe_capacity(batch)}) equal fixed layered-20 bit for bit; "
          f"bit errors probe {err_p}, fixed {err_f}", flush=True)
    if err_p > err_f + 1e-5 * coded30.numel():
        fail("the probe decode is worse than fixed layered-20")

    # -- phase 3b: the ofdm-qam16 preset -----------------------------------
    print("== phase 3b: the ofdm-qam16 preset at 8 and 10 dB", flush=True)
    p = PRESETS["ofdm-qam16"]
    q_code = get_code(p["code"])
    q_cfg = LinkConfig(**p["link"])
    q_sweep = SweepConfig(**p["sweep"])
    chunk_bits = q_sweep.steps_per_sync * q_sweep.batch_cw * q_code.k
    q_sweep = dataclasses.replace(
        q_sweep, snrdb=(8.0, 10.0), max_info_bits=4 * chunk_bits,
        min_info_bits=0, target_frame_errors=10**12)
    drive("ofdm-qam16", q_code, q_cfg, q_sweep, ["minsum_qc_layered"], card)

    # -- phase 3c: the wifi648 presets -------------------------------------
    print("== phase 3c: the wifi648-sweep and quantized-minsum presets",
          flush=True)
    p = PRESETS["wifi648-sweep"]
    s_code = get_code(p["code"])
    s_cfg = LinkConfig(**p["link"])
    s_sweep = SweepConfig(**p["sweep"])
    chunk_bits = s_sweep.steps_per_sync * s_sweep.batch_cw * s_code.k
    s_sweep = dataclasses.replace(
        s_sweep, snrdb=(2.0, 3.0), max_info_bits=4 * chunk_bits,
        min_info_bits=0, target_frame_errors=10**12)
    res, counts, ev, _ = drive("wifi648-sweep", s_code, s_cfg, s_sweep,
                               ["sumproduct_qc_layered"], card)
    sp_entry = mq.entry_point(s_code.qc, "sum-product", "layered")
    if not sp_entry.endswith("_sr") or not ev.entries.get(sp_entry):
        fail(f"wifi648-sweep did not launch {sp_entry}")
    launches["sumproduct_qc_layered"] = counts["sumproduct_qc_layered"]
    per_step["sumproduct_qc_layered"] = (counts["sumproduct_qc_layered"]
                                         / ev.mc_steps)
    if len(ev.auto) != 2:
        fail("wifi648-sweep: expected one es-auto calibration per point")
    bler_within_4sigma("wifi648-sweep @ 2 dB", res.coded_bler[0],
                       res.frames[0], WIFI648_SWEEP_BLER)
    # one step of the preset (8 link steps of 4096) in each of es auto's
    # modes at 2 dB, the mode it chose named
    chose = {a["snrdb"]: a["mode"] for a in ev.auto}.get(2.0)
    for mode in ("fixed", "probe"):
        cfg = dataclasses.replace(s_cfg, early_stop=mode == "probe",
                                  es_mode="probe" if mode == "probe"
                                  else "freeze")
        profile_step(
            mc_step(s_code, cfg, s_sweep.batch_cw,
                    steps_per_sync=s_sweep.steps_per_sync, device="cuda"),
            f"wifi648-sweep {mode}"
            + (" (es auto's choice at 2 dB)" if mode == chose else ""),
            card, snrdb=2.0,
            what=f"wifi648-sweep step ({s_sweep.steps_per_sync} link steps "
                 f"of {s_sweep.batch_cw}) at 2 dB")
    # the other three sum-product kernels on the preset's configuration
    two = dataclasses.replace(s_sweep, snrdb=(2.0,),
                              max_info_bits=2 * chunk_bits)
    for label, over, kname in (
            ("flooding", dict(bp_schedule="flooding", early_stop=False,
                              es_mode="freeze"), "sumproduct_qc_flooding"),
            ("flooding es freeze", dict(bp_schedule="flooding",
                                        es_mode="freeze"),
             "sumproduct_qc_flooding_es"),
            ("layered es requeue", dict(es_mode="requeue"),
             "sumproduct_qc_layered_es")):
        _, counts, ev, _ = drive(f"wifi648-sweep {label}", s_code,
                                 dataclasses.replace(s_cfg, **over), two,
                                 [kname], card)
        entry = mq.entry_point(s_code.qc, "sum-product",
                               "layered" if "layered" in kname
                               else "flooding", kname.endswith("_es"))
        if not entry.endswith("_sr") or not ev.entries.get(entry):
            fail(f"wifi648-sweep {label} did not launch {entry}")
        launches[kname] = counts[kname]
        per_step[kname] = counts[kname] / ev.mc_steps
    # the four sum-product kernels' rows at the shape that launches them
    for kname in SP_KERNELS:
        launches[f"{kname}@wifi648"] = launches[kname]
        per_step[f"{kname}@wifi648"] = per_step[kname]
    p = PRESETS["quantized-minsum"]
    q_code = get_code(p["code"])
    q_sweep = SweepConfig(**p["sweep"])
    q_sweep = dataclasses.replace(
        q_sweep, snrdb=(2.0,), max_info_bits=2 * chunk_bits,
        min_info_bits=0, target_frame_errors=10**12)
    for qb in p["msg_qbits_grid"]:
        q_cfg = dataclasses.replace(LinkConfig(**p["link"]), msg_qbits=qb)
        # at 3 bits the decoder adds errors: coded BER above uncoded, as
        # in the committed curve
        res, counts, ev, _ = drive(f"quantized-minsum msgq{qb}", q_code,
                                   q_cfg, q_sweep,
                                   ["minsum_qc_flooding_msgq"], card,
                                   coded_below=False)
        bler_within_4sigma(f"quantized-minsum msgq{qb} @ 2 dB",
                           res.coded_bler[0], res.frames[0],
                           QUANTIZED_BLER[qb])
        if qb == 4:
            launches[MSGQ_ROW] = counts["minsum_qc_flooding_msgq"]
            per_step[MSGQ_ROW] = counts["minsum_qc_flooding_msgq"] / \
                ev.mc_steps
    adc = dataclasses.replace(LinkConfig(**p["link"]), qbits=3, agc="global")
    drive("wifi648 3-bit ADC, global AGC", q_code, adc,
          dataclasses.replace(q_sweep, snrdb=(8.0,)),
          ["minsum_qc_flooding"], card)

    # -- phase 3d: the weights and layered-group paths ---------------------
    print("== phase 3d: --weights-ckpt and --layered-group at wifi1944, QPSK, "
          "OFDM-32, batch 32768", flush=True)
    # the configuration `sweep --code wifi1944 --method min-sum --schedule
    # layered --iters 6 --clamp 0 --weights-ckpt
    # docs/artifacts/edge_layered_1944_K6.npz` builds (the artifact decoded
    # without a clamp; the default is 20)
    args = build_parser().parse_args([
        "sweep", "--code", "wifi1944", "--method", "min-sum", "--schedule",
        "layered", "--iters", "6", "--clamp", "0", "--weights-ckpt",
        K6_NPZ])
    _, k6_cfg, _, _, k6_cli = sweep_configs(args)
    res_w, counts, ev, rate_w = drive("K6 per-edge layered-6", w1944, k6_cfg,
                                      sweep, ["minsum_qc_layered_w"], card,
                                      weights=k6_cli)
    launches["minsum_qc_layered_w"] = counts["minsum_qc_layered_w"]
    per_step["minsum_qc_layered_w"] = (counts["minsum_qc_layered_w"]
                                       / ev.mc_steps)
    res_p, _, _, rate_p = drive("plain layered-6", w1944, k6_cfg, sweep,
                                ["minsum_qc_layered"], card)
    for snr, bw, bp in zip(res_w.snrdb, res_w.coded_ber, res_p.coded_ber):
        print(f"  @ {snr:g} dB: coded BER K6 per-edge {bw!r} against plain "
              f"layered-6 {bp!r} ({bp / max(bw, 1e-300):.2f}x) [{card}]",
              flush=True)
        if not bw < bp:
            fail(f"K6 per-edge layered-6 @ {snr:g} dB: coded BER {bw} not "
                 f"below plain layered-6's {bp}")
    profile_step(mc_step(w1944, k6_cfg, batch, weights=k6_cli,
                         device="cuda"), "K6 per-edge layered-6", card)
    # the artifact's own channel, 8 x 32768 codewords per point
    k6_packed = pack_decoder_weights(k6, w1944, 6, "cuda")
    lay6 = dict(iterations=6, schedule="layered")
    for snrdb, ref in K6_BER.items():
        ber_w, fe = artifact_ber(w1944, snrdb, 8, batch, seed=41,
                                 weights=k6_packed, **lay6)
        ber_p, fe_p = artifact_ber(w1944, snrdb, 8, batch, seed=41, **lay6)
        bound_rel = 4 / math.sqrt(max(fe, 1))
        rel = abs(ber_w - ref) / ref
        print(f"  artifact channel @ {snrdb:g} dB: K6 per-edge BER {ber_w!r} "
              f"({fe} frames in error; artifact {ref!r}, relative difference "
              f"{rel:.4f} against 4/sqrt(frames) {bound_rel:.4f}); plain "
              f"layered-6 {ber_p!r} ({fe_p} frames; artifact "
              f"{K6_PLAIN_BER[snrdb]!r}); ratio {ber_p / ber_w:.2f} [{card}]",
              flush=True)
        if rel > bound_rel:
            fail(f"K6 per-edge @ {snrdb:g} dB: BER {ber_w} is not within "
                 f"{bound_rel:.4f} relative of the artifact's {ref}")
        if snrdb == 1.75 and not ber_p >= 5 * ber_w:
            fail(f"K6 per-edge @ 1.75 dB: BER {ber_w} is not 5x below plain "
                 f"layered-6's {ber_p}")
    # flooding-12 with per-edge weights (random, as no flooding decoder is
    # committed), one point
    w12 = random_edge_weights(w1944, 12, seed=42)
    _, counts, ev, _ = drive(
        "flooding-12 per-edge (random weights)", w1944,
        LinkConfig(bp_iterations=12, bp_method="min-sum", clamp=None),
        dataclasses.replace(sweep, snrdb=(1.5,)), ["minsum_qc_flooding_w"],
        card, weights=w12)
    launches["minsum_qc_flooding_w"] = counts["minsum_qc_flooding_w"]
    per_step["minsum_qc_flooding_w"] = (counts["minsum_qc_flooding_w"]
                                        / ev.mc_steps)
    # `sweep --code wifi1944 --method min-sum --schedule layered --iters 20
    # --clamp 0 --layered-group 4`, beside
    # layered-20 and phase 3's flooding-20 on the same seeds
    args = build_parser().parse_args([
        "sweep", "--code", "wifi1944", "--method", "min-sum", "--schedule",
        "layered", "--iters", "20", "--clamp", "0", "--layered-group", "4"])
    _, g4_cfg, _, _, _ = sweep_configs(args)
    res_g4, counts, ev, rate_g4 = drive("layered-20 G=4", w1944, g4_cfg,
                                        sweep, ["minsum_qc_layered"], card)
    launches[G4_ROW] = counts["minsum_qc_layered"]
    per_step[G4_ROW] = counts["minsum_qc_layered"] / ev.mc_steps
    g4_entries = ev.entries
    if set(g4_entries) != {"minsum_qc_layered_gs"}:
        fail(f"layered-20 G=4 launched {g4_entries}, not the _gs kernel")
    profile_step(mc_step(w1944, g4_cfg, batch, device="cuda"),
                 "layered-20 G=4", card)
    res_l20, _, ev, rate_l20 = drive(
        "layered-20", w1944, dataclasses.replace(g4_cfg, bp_layered_group=1),
        sweep, ["minsum_qc_layered"], card)
    l20_entries = ev.entries
    res_f20, rate_f20 = main_res["flooding-20"]
    for i, snr in enumerate(res_g4.snrdb):
        print(f"  @ {snr:g} dB coded BER / BLER: layered-20 "
              f"({', '.join(l20_entries)}) {res_l20.coded_ber[i]!r} / "
              f"{res_l20.coded_bler[i]!r}, G=4 ({', '.join(g4_entries)}) "
              f"{res_g4.coded_ber[i]!r} / {res_g4.coded_bler[i]!r}, "
              f"flooding-20 {res_f20.coded_ber[i]!r} / "
              f"{res_f20.coded_bler[i]!r} [{card}]", flush=True)
    print(f"  decoded info bits/s: layered-20 {rate_l20!r}, G=4 {rate_g4!r}, "
          f"flooding-20 {rate_f20!r}; K6 per-edge layered-6 {rate_w!r}, "
          f"plain layered-6 {rate_p!r} [{card}]", flush=True)
    # its sum-product form: `sweep ... --method sum-product --layered-group
    # 4`, one point
    args = build_parser().parse_args([
        "sweep", "--code", "wifi1944", "--method", "sum-product",
        "--schedule", "layered", "--iters", "20", "--layered-group", "4"])
    _, sp_g4_cfg, _, _, _ = sweep_configs(args)
    _, counts, ev, _ = drive("sum-product layered-20 G=4", w1944,
                             sp_g4_cfg,
                             dataclasses.replace(sweep, snrdb=(1.5,)),
                             ["sumproduct_qc_layered"], card)
    if set(ev.entries) != {"sumproduct_qc_layered_gs"}:
        fail(f"sum-product layered-20 G=4 launched {ev.entries}")
    launches[SP_G4_ROW] = counts["sumproduct_qc_layered"]
    per_step[SP_G4_ROW] = counts["sumproduct_qc_layered"] / ev.mc_steps
    # the committed TPU sweeps of qc1944_r23, r34 and r56 (rows of degree
    # 9-18: the wide word's kernels), built from the flags they ran with
    # on their Eb/N0 grid, at one waterfall point each, the BLER within 4σ
    # of the artifact's
    high_llr = {}
    for cname, k in HIGH_RATE.items():
        with open(HIGH_RATE_SWEEP.format(cname)) as f:
            art = json.load(f)
        hcode, hcfg, hsweep, _, _ = sweep_configs(build_parser().parse_args(
            ["sweep", "--code", cname, *HIGH_RATE_FLAGS]))
        link_art = {key: v for key, v in dataclasses.asdict(hcfg).items()
                    if key in art["link"]}
        if link_art != art["link"]:
            fail(f"{cname}: sweep_configs gives the link {link_art}, not the "
                 f"artifact's {art['link']}")
        off = max(abs(x - y) for x, y in zip(hsweep.snrdb, art["snrdb"]))
        print(f"  {cname}: --snr-unit eb grid {hsweep.snrdb} against the "
              f"artifact's Es/N0 points, max |diff| {off!r} dB", flush=True)
        if len(hsweep.snrdb) != len(art["snrdb"]) or off > 1e-9:
            fail(f"{cname}: the --snr-unit eb grid {hsweep.snrdb} is not the "
                 f"artifact's {art['snrdb']} within 1e-9")
        snr = hsweep.snrdb[k]
        row = f"minsum_qc_layered_es@{cname}"
        res, counts, ev, rate = drive(
            f"{cname} layered-20 es freeze", hcode, hcfg,
            dataclasses.replace(sweep, snrdb=(snr,),
                                max_info_bits=steps_per_point * batch
                                * hcode.k),
            ["minsum_qc_layered_es"], card)
        if set(ev.entries) != {"minsum_qc_layered_es_cw"}:
            fail(f"{cname}: launched {ev.entries}, not the wide word's "
                 "kernel")
        print(f"  {cname}: launched {ev.entries}", flush=True)
        launches[row] = counts["minsum_qc_layered_es"]
        per_step[row] = counts["minsum_qc_layered_es"] / ev.mc_steps
        bler_within_4sigma(f"{cname} @ {snr:g} dB", res.coded_bler[0],
                           res.frames[0],
                           (art["coded_bler"][k], art["frames"][k]))
        high_llr[cname] = (hcode, hcfg, snr)
    # one error-floor point of qc1944_r56 on the campaign's channel, 8 x
    # 32768 frames a decoder through bp_decode, the counters set to 0 just
    # before and read just after each decoder's run; FER within 4σ of the
    # artifact's
    fcode = get_code(FLOOR_CODE)
    for label, (ref_fer, ref_frames, kw, row) in FLOOR_FER.items():
        mq.reset_launch_counts()
        ber, fe = artifact_ber(fcode, FLOOR_SNR, 8, batch, seed=43, **kw)
        counts = dict(mq.LAUNCHES)
        entries = dict(mq.ENTRY_LAUNCHES)
        kname = mq.kernel_name("min-sum", kw["schedule"])
        if counts[kname] != 8 or set(entries) != {kname + "_cw"}:
            fail(f"{FLOOR_CODE} {label}: launched {entries}, not {kname}_cw "
                 "once in each of 8 decodes")
        launches[row] = counts[kname]
        per_step[row] = counts[kname] / 8  # launches a decode
        print(f"  {FLOOR_CODE} {label} @ {FLOOR_SNR:g} dB (error-floor "
              f"channel, {entries}): coded BER {ber!r}, {fe} frames in error "
              f"of {8 * batch} [{card}]", flush=True)
        bler_within_4sigma(f"{FLOOR_CODE} {label} FER @ {FLOOR_SNR:g} dB",
                           fe / (8 * batch), 8 * batch, (ref_fer, ref_frames))

    # the group-serial min-sum and the sum-product forms on the wide rows
    # (the _gw and _rw kernels), each through run_sweep at full width at
    # its code's TPU-sweep point, the counters set to 0 just before and
    # read just after each run: qc1944_r34 layered-20 G = 4 beside
    # layered-20 and flooding-20 (the _cw kernels) on the same seeds, its
    # BLER between theirs within 4σ (a group-serial sweep updates the
    # posterior less often than serial-C and more often than flooding: on
    # 6 block rows G = 4 is two groups, and its BLER is not serial-C's);
    # qc1944_r56 sum-product layered-20 es auto beside min-sum layered-20,
    # its BLER at or below min-sum's within 4σ; and the other forms of
    # WIDE_ROWS, 2 steps each
    t3w = time.perf_counter()
    for wrow, (cname, want, flags) in WIDE_ROWS.items():
        kname = wrow.split("@")[0]
        wsched = "flooding" if "flooding" in kname else "layered"
        wcode, wcfg, wsw, _, _ = sweep_configs(build_parser().parse_args(
            ["sweep", "--code", cname, "--schedule", wsched, "--clamp", "0",
             "--snr", str(WIDE_EBN0[cname]), "--snr-unit", "eb", *flags]))
        entry = mq.entry_point(
            wcode.qc, wcfg.bp_method, wsched, "_es" in kname, False,
            "_w" in kname, layered_group=want.get("layered_group", 1))
        steps = 3 if wrow in (G4_WIDE_ROW, SP_WIDE_ROW) else 2
        wsweep = dataclasses.replace(sweep, snrdb=wsw.snrdb,
                                     max_info_bits=steps * batch * wcode.k)
        w = (random_edge_weights(wcode, 6, seed=53) if "_w" in kname
             else None)
        res, counts, ev, _ = drive(f"{wrow} ({' '.join(flags)})", wcode,
                                   wcfg, wsweep, [kname], card, weights=w)
        if set(ev.entries) != {entry} or not entry.endswith(
                ("_gw", "_rw", "_lw")):
            fail(f"{wrow}: launched {ev.entries}, not the wide rows' {entry}")
        launches[wrow] = counts[kname]
        per_step[wrow] = counts[kname] / ev.mc_steps
        if wrow in (G4_WIDE_ROW, SP_WIDE_ROW):
            # the same frames through min-sum layered-20 and, beside G = 4,
            # flooding-20 (the _cw kernels); 4σ of each difference
            got, frames = res.coded_bler[0], res.frames[0]
            ref = {}
            for sched in ("layered", "flooding")[:1 + (wrow == G4_WIDE_ROW)]:
                ms_cfg = dataclasses.replace(
                    wcfg, bp_method="min-sum", bp_schedule=sched,
                    bp_layered_group=1, early_stop=False)
                kms = mq.kernel_name("min-sum", sched)
                r, _, ev, _ = drive(f"{cname} min-sum {sched}-20", wcode,
                                    ms_cfg, wsweep, [kms], card)
                if set(ev.entries) != {kms + "_cw"}:
                    fail(f"{cname} min-sum {sched}-20 launched {ev.entries}")
                pool = (got + r.coded_bler[0]) / 2
                ref[sched] = (r.coded_bler[0], 4 * math.sqrt(
                    max(pool * (1 - pool), 1e-300) * 2 / frames))
            print(f"  {wrow.split('@')[0]} on {cname} @ {WIDE_EBN0[cname]:g} "
                  f"dB Eb/N0 ({entry}): BLER {got!r} on {frames:g} frames; "
                  f"min-sum on the same frames (BLER, 4σ): {ref} [{card}]",
                  flush=True)
            base, band = ref["layered"]
            if wrow == G4_WIDE_ROW and not (
                    base - band <= got <= sum(ref["flooding"])):
                fail(f"{wrow}: BLER {got} is not between layered-20's "
                     f"{base} and flooding-20's {ref['flooding'][0]} within "
                     "4σ")
            if wrow == SP_WIDE_ROW and got - base > band:
                fail(f"{wrow}: sum-product BLER {got} is above min-sum's "
                     f"{base} by more than 4σ")
    # the other forms of the _lw kernels (LW_ROWS), each decoded once
    # through bp_decode, the counters set to 0 just before and read just
    # after: exactly its entry point, once
    from ldpc_sims_tpu_torch.kernels.compare import HIGH_RATE_SWEEP as TPU_AT

    lw_code = get_code(LW_CODE)
    lw_x, lw_cw = channel_llrs(lw_code, batch, TPU_AT[LW_CODE], seed=15,
                               with_coded=True)
    lw_w = random_edge_weights(lw_code, 12, seed=54)
    for row, (form, dsfx) in LW_ROWS.items():
        kw = lw_kwargs(form, dsfx, lw_w)
        mq.reset_launch_counts()
        bits = bp_decode(lw_x, lw_code, **kw)
        torch.cuda.synchronize()
        entry = lw_entry(lw_code, kw)
        if dict(mq.ENTRY_LAUNCHES) != {entry: 1}:
            fail(f"{row}: launched {dict(mq.ENTRY_LAUNCHES)}, not {entry} "
                 "once")
        launches[row], per_step[row] = 1, 1  # a decode
        ber = float((bits != lw_cw).float().mean())
        print(f"  {row} ({entry}, bp_decode at Es/N0 "
              f"{TPU_AT[LW_CODE]:.3f} dB): coded BER {ber!r} [{card}]",
              flush=True)
    print(f"  the wide rows' runs took {time.perf_counter() - t3w:.1f} s",
          flush=True)

    # -- phase 3e: the bigcode scale run ----------------------------------
    print("== phase 3e: the bigcode run at full width (qc8448_r12, "
          "qc12288_r12, batch 16384, pipe cut from 16 to 4)", flush=True)
    from ldpc_sims_tpu_torch.examples import bigcode

    big_batch, big_pipe = 16384, 4
    # one qc12288 layered-10 step at each storage type: torch.profiler,
    # and CUDA events around its parts (late in this script's run the
    # profiler has missed a step's first kernels, so the events also give
    # the breakdown)
    big = get_code("qc12288_r12")
    for dt, sfx in {torch.float32: "f32", **storage_rows}.items():
        marks = []

        def big_step(seed, _snrdb, dt=dt, marks=marks):
            marks[:] = [torch.cuda.Event(enable_timing=True)
                        for _ in range(4)]
            marks[0].record()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            x = torch.randn((big_batch, big.n), generator=gen,
                            device="cuda") * 2.0 - 4.0
            marks[1].record()
            bits = bp_decode(x, big, iterations=10, schedule="layered",
                             dtype=dt, msg_qclip=24.0)
            marks[2].record()
            ones = bits.sum(dtype=torch.int64)
            marks[3].record()
            return {"ones": ones}
        wall_us = profile_step(big_step, f"qc12288 layered-10 {sfx}", card,
                               what="bigcode step (batch 16384, random "
                               "LLRs)")
        parts = [marks[i].elapsed_time(marks[i + 1]) for i in range(3)]
        busy = sum(parts)
        print(f"    by CUDA events: LLRs {parts[0]!r} ms, decode "
              f"{parts[1]!r} ms, bit count {parts[2]!r} ms; their spans "
              f"{busy!r} ms of the wall {wall_us / 1e3!r} ms, idle share "
              f"at most {1 - busy * 1e3 / wall_us!r} [{card}]", flush=True)

    big_need = [mq.kernel_name("min-sum", "flooding")] + [
        mq.kernel_name("min-sum", "layered", dtype=dt)
        for dt in (torch.float32, *storage_rows)]
    big_launch = {}
    for name in ("qc8448_r12", "qc12288_r12"):
        n_big = get_code(name).n
        mq.reset_launch_counts()
        rec, frame_errs = bigcode.run([name], big_batch, big_pipe,
                                      (1.75, 2.25))
        counts = dict(mq.LAUNCHES)
        for k in big_need:
            if counts[k] == 0:
                fail(f"bigcode {name}: the main path never launched {k}")
        big_launch[name] = {k: counts[k] for k in big_need}
        launched = {k: v for k, v in counts.items() if v}
        print(f"  bigcode {name}: launches {launched} (one a decode) "
              f"[{card}]", flush=True)
        ent = rec["codes"][name]
        for label in bigcode.CONFIGS:
            r = ent[label]
            print(f"  bigcode {name} {label}: {r['ms_per_step']!r} ms a "
                  f"decode, {r['info_bits_per_s']!r} decoded info bits/s "
                  f"(pipe {big_pipe}, median of 3) [{card}]", flush=True)
        for snr in (1.75, 2.25):
            errs = frame_errs[name][snr]
            for label, ref in zip(("flooding-20 f32", "layered-10 f32"),
                                  BIGCODE_BER[name, snr]):
                sm = bigcode.summarize(errs[label], n_big)
                sig = math.sqrt(2) * sm["se"]
                print(f"  bigcode {name} @ {snr:g} dB {label}: BER "
                      f"{sm['ber']!r} ({sm['frames_in_error']} of "
                      f"{sm['frames']} frames in error) against the "
                      f"artifact's {ref!r}, 4σ = {4 * sig!r} [{card}]",
                      flush=True)
                if not abs(sm["ber"] - ref) <= 4 * sig:
                    fail(f"bigcode {name} @ {snr:g} dB {label}: BER "
                         f"{sm['ber']} not within 4σ of {ref}")
            base = errs["layered-10 f32"]
            ber_f = bigcode.summarize(base, n_big)["ber"]
            for label in ("layered-10 bf16", "layered-10 int8"):
                d = (errs[label] - base).double()
                sig = float(d.std()) / (d.numel() ** 0.5 * n_big)
                ber_x = bigcode.summarize(errs[label], n_big)["ber"]
                print(f"  bigcode {name} @ {snr:g} dB {label}: BER "
                      f"{ber_x!r} against f32 layered-10 {ber_f!r} (limit "
                      f"1.2x + 4σ of the paired difference = "
                      f"{1.2 * ber_f + 4 * sig!r}) [{card}]", flush=True)
                if not ber_x <= 1.2 * ber_f + 4 * sig:
                    fail(f"bigcode {name} @ {snr:g} dB: {label} BER {ber_x} "
                         f"above 1.2 x f32's {ber_f} + 4σ")
    # -- phase 3f: the JAX CLI's defaults and the small-cpu preset --------
    print("== phase 3f: sweep with no flags (ref6432, sum-product-ref-3, "
          "clamp 20, batch 4096) and the small-cpu and reference presets",
          flush=True)
    args = build_parser().parse_args(["sweep"])
    ref_code, ref_cfg, ref_sweep, _, _ = sweep_configs(args)
    ref_sweep = dataclasses.replace(
        ref_sweep, snrdb=tuple(TABLE_A), target_frame_errors=10**12,
        max_info_bits=8 * ref_sweep.batch_cw * ref_code.k)
    res, _, _, _ = drive("sweep with no flags", ref_code, ref_cfg,
                         ref_sweep, [], card)
    for snr, ber, bits in zip(res.snrdb, res.coded_ber, res.info_bits):
        exp = TABLE_A[snr]
        tol = 4 * math.sqrt(exp * (1 - exp) / bits) + 0.1 * exp
        print(f"  @ {snr:g} dB: coded BER {ber!r} against table A's {exp!r} "
              f"(4σ + 10% = {tol!r}) [{card}]", flush=True)
        if abs(ber - exp) > tol:
            fail(f"sweep with no flags @ {snr:g} dB: coded BER {ber} is not "
                 f"within 4σ + 10% of {exp}")
    for preset, snr in (("small-cpu", 2.0), ("reference", 6.0)):
        p = PRESETS[preset]
        drive(f"preset {preset}", get_code(p["code"]),
              LinkConfig(**p["link"]),
              dataclasses.replace(SweepConfig(**p["sweep"]), snrdb=(snr,)),
              [], card)

    # -- phase 3g: the dense backend, pair weights, the sweep's outputs ---
    print("== phase 3g: the dense backend beside gather, pair-flavor weights, "
          "sweep --profile", flush=True)
    t3g = time.perf_counter()
    dense_vs_gather(get_code("ref6432"), 32768, card, iterations=3,
                    method="sum-product-ref", clamp=20.0)
    peg128 = get_code("peg128_64")
    dense_vs_gather(peg128, 32768, card, iterations=10, method="min-sum")
    peg4096 = make_regular_ldpc(4096, 2048, 3, seed=7, backend="native")
    g4096 = peg4096.graph
    print(f"  native PEG {peg4096.name}: Ec = {g4096.n_checks * g4096.dc}, "
          f"n·Ec = {g4096.n_vars * g4096.n_checks * g4096.dc}", flush=True)
    if g4096.n_checks * g4096.dc <= 1024:
        fail(f"{peg4096.name} does not take the factored routing")
    # min-sum-20 on n = 4096: up to one decoded codeword in a thousand
    # outside the tolerance (2 of 6771 on an NVIDIA H100 80GB HBM3)
    dense_vs_gather(peg4096, 8192, card, per_mille=1, iterations=20,
                    method="min-sum")
    pair_weights(peg128, w1944, card)
    sweep_outputs(card)
    print(f"  phase 3g took {time.perf_counter() - t3g:.1f} s", flush=True)

    # -- phase 3h: evaluate, checkpoints, the mesh on torch.distributed ---
    print("== phase 3h: evaluate with a JAX-format checkpoint, the NN "
          "forward, sweep --multihost, scaling-probe, run_grid", flush=True)
    t3h = time.perf_counter()
    ev3h = evaluate_phase(card, "wifi1944", batch)
    launches[EVAL_ROW] = ev3h["launches"]
    per_step[EVAL_ROW] = ev3h["launches"] / ev3h["points"]  # a point
    print(f"  phase 3h took {time.perf_counter() - t3h:.1f} s", flush=True)

    # -- phase 3i: training on the card ------------------------------------
    print("== phase 3i: train-minsum, train_neural_bp, train_llr card "
          "against CPU, train-joint", flush=True)
    t3i = time.perf_counter()
    tr3i = training_phase(card, sweep)
    launches[TRAIN_MINSUM_ROW] = tr3i["minsum_launches"]
    per_step[TRAIN_MINSUM_ROW] = tr3i["minsum_per_step"]
    launches[TRAIN_PROBE_ROW] = tr3i["probe_launches"]
    per_step[TRAIN_PROBE_ROW] = 2  # a probe decodes at its two SNRs
    print(f"  phase 3i took {time.perf_counter() - t3i:.1f} s", flush=True)

    # -- phase 3j: the rest of the library and the CLI ---------------------
    print("== phase 3j: train-grid/evaluate-grid, density evolution, the "
          "error-floor campaign, noise-study, evaluate-joint, code-info",
          flush=True)
    t3j = time.perf_counter()
    lib3j = library_phase(card)
    launches[GRID_ROW] = lib3j["grid"]["launches"]
    per_step[GRID_ROW] = 3  # a cell: Traditional, Quantized, NN
    for kname, (rname, _) in FLOOR_ROWS.items():
        launches[rname] = lib3j["floor"]["counts"][kname]
        per_step[rname] = lib3j["floor"]["counts"][kname] / lib3j[
            "floor"]["steps"]  # a campaign step (every schedule)
    launches[DE_ROW] = lib3j["de"]["launches"]
    per_step[DE_ROW] = 1  # a decode
    print(f"  phase 3j took {time.perf_counter() - t3j:.1f} s", flush=True)

    # -- phase 3k: the training and study examples -------------------------
    print("== phase 3k: quantized_llr_study, tanh_family, train_minsum_1944, "
          "train_minsum_short, train_minsum_tail7, train_edge_1944, "
          "train_edge_layered_1944", flush=True)
    t3k = time.perf_counter()
    ex3k = examples_phase(card)
    for example, (kname, rname) in EXAMPLE_ROWS.items():
        launches[rname] = ex3k["launches"][example][kname]
        per_step[rname] = 1  # a decode
    print(f"  phase 3k took {time.perf_counter() - t3k:.1f} s", flush=True)

    # -- phase 4: kernel timing --------------------------------------------
    print("== phase 4: kernel timing at batch 32768 (CUDA events)",
          flush=True)
    llr = channel_llrs(w1944, batch, 1.5, seed=7)
    llr25 = channel_llrs(w1944, batch, 2.5, seed=12)
    E = len(qc_plan(w1944.qc)[0]) * w1944.qc.z
    n = w1944.n

    def bound(nbytes, ops, sfu_ops=0):
        """The larger of the byte time, the f32 issue time of ``ops`` and
        the special-function-unit time of ``sfu_ops``."""
        t_bytes = nbytes / BYTES_PER_S * 1e3
        t_ops = max(ops / F32_OPS_PER_S, sfu_ops / SFU_OPS_PER_S) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    def row(name, ms, plain_ms, bnd, entry):
        full = (f", full messages: {FULL_MESSAGE_MS[name]!r} ms"
                if name in FULL_MESSAGE_MS else "")
        print(f"  {name} ({entry}): {ms!r} ms (plain {plain_ms!r} ms, bound "
              f"{bnd[0]!r} ms, {bnd[1]}{full}) [{card}]", flush=True)
        return {
            "name": name,
            # the CUDA entry point the row's launches run (name_cs: on the
            # compressed check state)
            "entry": entry,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL,
            "launches": launches[name],
            "launches_per_mc_step": per_step[name],
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bnd[0],
            "bound_by": bnd[1],
            # no single PyTorch call computes a BP decode
            "library_ms": None,
        }

    timed = {
        "minsum_qc_flooding": dict(iterations=20, schedule="flooding"),
        "minsum_qc_layered": dict(iterations=8, schedule="layered",
                                  alpha=a8, beta=b8),
    }
    kernels = [encode_row(card, batch)]
    for name, kw in timed.items():
        # the kernel against its plain version at the main path's shape
        max_err[name] = max(max_err[name], compare(
            mq.bp_qc_cuda(llr, w1944.qc, output="posterior", **kw),
            decode_roll(llr, w1944.qc, output="posterior", **kw),
            f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, w1944.qc, **kw), 20)
        plain_ms = cuda_time_ms(
            lambda: decode_roll(llr, w1944.qc, **kw), 3, warmup=1)
        # bytes: LLRs read once (f32), hard bits written once (int8)
        kernels.append(row(name, ms, plain_ms, bound(
            batch * n * (4 + 1), batch * E * edge_ops(**kw)),
            mq.entry_point(w1944.qc, "min-sum", kw["schedule"])))

    # the flooding kernel on the evaluate path: one decode of each of a
    # point's three LLR sets (Traditional, Quantized, NN) at 1.5 dB
    kw = timed["minsum_qc_flooding"]
    ms = plain_ms = 0.0
    for tag, x in ev3h["llrs"].items():
        x = x.contiguous()
        max_err[EVAL_ROW] = max(max_err[EVAL_ROW], compare(
            mq.bp_qc_cuda(x, w1944.qc, output="posterior", **kw),
            decode_roll(x, w1944.qc, output="posterior", **kw),
            f"{EVAL_ROW} ({tag} LLRs) at batch {batch}"))
        ms += cuda_time_ms(lambda: mq.bp_qc_cuda(x, w1944.qc, **kw), 10) / 3
        plain_ms += cuda_time_ms(
            lambda: decode_roll(x, w1944.qc, **kw), 1, warmup=1) / 3
    kernels.append(row(EVAL_ROW, ms, plain_ms, bound(
        batch * n * (4 + 1), batch * E * edge_ops(**kw)),
        mq.entry_point(w1944.qc, "min-sum", "flooding")))

    # the early-stop kernels at 2.5 dB, bound by the iterations they ran
    for sched in ("flooding", "layered"):
        name = mq.KERNELS["min-sum", sched, True, False]
        kw = dict(iterations=20, schedule=sched, early_stop=True)
        kb, ki = mq.bp_qc_cuda(llr25, w1944.qc, output="hard_iters", **kw)
        pb, pi = decode_roll(llr25, w1944.qc, output="hard_iters", **kw)
        max_err[name] = max(max_err[name], exact(
            [(kb, pb), (ki, pi)], f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr25, w1944.qc, **kw), 20)
        plain_ms = cuda_time_ms(
            lambda: decode_roll(llr25, w1944.qc, **kw), 3, warmup=1)
        ran = int(ki.sum())
        checks = batch + ran  # the entry check and one after each iteration
        print(f"  {name}: mean iterations {ran / batch:.4f} of 20",
              flush=True)
        # bytes: LLRs, bits, and the iteration counts (int32)
        kernels.append(row(name, ms, plain_ms, bound(
            batch * (n * (4 + 1) + 4),
            ran * E * edge_ops(sched, 1) + checks * E * OPS_PER_EDGE_CHECK,
        ), mq.entry_point(w1944.qc, "min-sum", sched, True)))

    # the layered kernel's two launches in one es-auto probe chunk at 3.5
    # dB, where es auto chose probe: the hard_unsat probe-4 over the whole
    # batch, then layered-20 over the codewords it left unsatisfied
    qc = w1944.qc
    full = dict(iterations=20, schedule="layered")
    per_it = E * edge_ops("layered", 1)
    per_check = E * OPS_PER_EDGE_CHECK
    io_bytes = batch * n * 5  # LLRs read once, bits written once
    llr35 = channel_llrs(w1944, batch, 3.5, seed=13)
    probe = dict(iterations=4, schedule="layered", output="hard_unsat")
    kb, ku = mq.bp_qc_cuda(llr35, qc, **probe)
    pb, pu = decode_roll(llr35, qc, **probe)
    max_err[ES_AUTO_ROW] = exact([(kb, pb), (ku, pu)],
                                 f"hard_unsat probe-4 at batch {batch}")
    done = ku == 0
    todo = batch - int(done.sum())
    if todo > mq.probe_capacity(batch):
        fail(f"3.5 dB: {todo} stragglers overflow the probe's capacity")
    kb = mq.bp_qc_cuda(llr35, qc, done_in=done, **full)
    pb = decode_roll(llr35, qc, done_in=done, **full)
    max_err[ES_AUTO_ROW] = max(max_err[ES_AUTO_ROW], exact(
        [(kb[~done], pb[~done])], f"done_in layered-20 at batch {batch}"))
    p_ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr35, qc, **probe), 20)
    p_plain = cuda_time_ms(lambda: decode_roll(llr35, qc, **probe), 3, 1)
    p_bytes, p_ops = io_bytes + batch * 4, batch * (4 * per_it + per_check)
    b_ms, b_by = bound(p_bytes, p_ops)
    print(f"  hard_unsat probe-4 at 3.5 dB: {p_ms!r} ms (plain {p_plain!r} "
          f"ms, bound {b_ms!r} ms, {b_by}) [{card}]", flush=True)
    d_ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr35, qc, done_in=done,
                                              **full), 20)
    d_plain = cuda_time_ms(
        lambda: decode_roll(llr35, qc, done_in=done, **full), 3, 1)
    # bytes: the flags, and the LLRs and bits of the decoded codewords
    d_bytes, d_ops = todo * n * 5 + batch * 4, todo * 20 * per_it
    b_ms, b_by = bound(d_bytes, d_ops)
    print(f"  done_in layered-20 at 3.5 dB ({todo} of {batch} decoded): "
          f"{d_ms!r} ms (plain {d_plain!r} ms, bound {b_ms!r} ms, {b_by}) "
          f"[{card}]", flush=True)
    kernels.append(row(ES_AUTO_ROW, p_ms + d_ms, p_plain + d_plain,
                       bound(p_bytes + d_bytes, p_ops + d_ops),
                       mq.entry_point(qc, "min-sum", "layered")))

    # the sum-product kernels (fixed at 1.5 dB, early stop at 2.5 dB) and
    # the 4-bit quantized flooding kernel at 1.5 dB, bound by the f32 and
    # MUFU instructions of their edge sequence in the SASS
    ins = edge_instruction_counts(edge_probe)
    sp_f32, sp_mufu, sp_all = ins["probe_sp_edge"]
    q_f32, q_mufu, _ = ins["probe_msgq"]
    print(f"  SASS per edge: sum-product sequence {sp_f32} f32 + {sp_mufu} "
          f"MUFU instructions ({sp_all} in all); quantization {q_f32} f32 "
          f"+ {q_mufu} MUFU", flush=True)
    for sched in ("flooding", "layered"):
        name = mq.KERNELS["sum-product", sched, False, False]
        kw = dict(iterations=20, schedule=sched, method="sum-product")
        max_err[name] = max(max_err[name], compare(
            mq.bp_qc_cuda(llr, w1944.qc, output="posterior", **kw),
            decode_roll(llr, w1944.qc, output="posterior", **kw),
            f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, w1944.qc, **kw), 10)
        plain_ms = cuda_time_ms(
            lambda: decode_roll(llr, w1944.qc, **kw), 2, warmup=1)
        per = SP_OPS_PER_EDGE_ITER[sched] + sp_f32
        kernels.append(row(name, ms, plain_ms, bound(
            batch * n * 5, batch * 20 * E * per, batch * 20 * E * sp_mufu),
            mq.entry_point(w1944.qc, "sum-product", sched)))
    for sched in ("flooding", "layered"):
        name = mq.KERNELS["sum-product", sched, True, False]
        kw = dict(iterations=20, schedule=sched, early_stop=True,
                  method="sum-product")
        kb, ki = mq.bp_qc_cuda(llr25, w1944.qc, output="hard_iters", **kw)
        pb, pi = decode_roll(llr25, w1944.qc, output="hard_iters", **kw)
        max_err[name] = max(max_err[name], exact(
            [(kb, pb), (ki, pi)], f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr25, w1944.qc, **kw), 10)
        plain_ms = cuda_time_ms(
            lambda: decode_roll(llr25, w1944.qc, **kw), 2, warmup=1)
        ran = int(ki.sum())
        print(f"  {name}: mean iterations {ran / batch:.4f} of 20",
              flush=True)
        per = SP_OPS_PER_EDGE_ITER[sched] + sp_f32
        kernels.append(row(name, ms, plain_ms, bound(
            batch * (n * 5 + 4),
            ran * E * per + (batch + ran) * E * OPS_PER_EDGE_CHECK,
            ran * E * sp_mufu),
            mq.entry_point(w1944.qc, "sum-product", sched, True)))
    # the same four kernels at the wifi648-sweep preset's shape that
    # launches them: wifi648 at 2.0 dB, batch 4096, exactly equal to the
    # plain version (the early-stop forms bound by the iterations they ran)
    b648 = 4096
    x648 = channel_llrs(w648, b648, 2.0, seed=14)
    E648 = len(qc_plan(w648.qc)[0]) * w648.qc.z
    for kname in SP_KERNELS:
        name = f"{kname}@wifi648"
        es = kname.endswith("_es")
        sched = "layered" if "layered" in kname else "flooding"
        kw = dict(iterations=20, schedule=sched, method="sum-product",
                  early_stop=es)
        out = "hard_iters" if es else "posterior"
        k = mq.bp_qc_cuda(x648, w648.qc, output=out, **kw)
        p = decode_roll(x648, w648.qc, output=out, **kw)
        max_err[name] = exact(list(zip(k, p)) if es else [(k, p)],
                              f"{name} at batch {b648}")
        ran = int(k[1].sum()) if es else b648 * 20
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(x648, w648.qc, **kw), 20)
        plain_ms = cuda_time_ms(lambda: decode_roll(x648, w648.qc, **kw), 2,
                                warmup=1)
        if es:
            print(f"  {name}: mean iterations {ran / b648:.4f} of 20",
                  flush=True)
        per = SP_OPS_PER_EDGE_ITER[sched] + sp_f32
        checks = (b648 + ran) * E648 * OPS_PER_EDGE_CHECK if es else 0
        kernels.append(row(name, ms, plain_ms, bound(
            b648 * (w648.n * 5 + (4 if es else 0)),
            ran * E648 * per + checks, ran * E648 * sp_mufu),
            mq.entry_point(w648.qc, "sum-product", sched, es)))
    kw = dict(iterations=20, schedule="flooding", msg_qbits=4)
    max_err[MSGQ_ROW] = compare(
        mq.bp_qc_cuda(llr, w1944.qc, output="posterior", **kw),
        decode_roll(llr, w1944.qc, output="posterior", **kw),
        f"{MSGQ_ROW} at batch {batch}")
    ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, w1944.qc, **kw), 20)
    plain_ms = cuda_time_ms(lambda: decode_roll(llr, w1944.qc, **kw), 3, 1)
    kernels.append(row(MSGQ_ROW, ms, plain_ms, bound(
        batch * n * 5, batch * E * (edge_ops("flooding", 20) + 20 * q_f32),
        batch * E * 20 * q_mufu),
        mq.entry_point(w1944.qc, "min-sum", "flooding", quantized=True)))
    # the weighted kernels and the group-serial layered kernel at 1.5 dB:
    # the K6 per-edge layered-6 decoder (its ms arrays as the α/β table),
    # flooding-12 with random per-edge weights, layered-20 with G = 4; the
    # weight tables' bytes count once
    w12_tables = pack_decoder_weights(w12, w1944, 12, "cuda")["tables"]
    for name, kw, nbytes, ops in (
            ("minsum_qc_layered_w",
             dict(iterations=6, schedule="layered", alpha=a6, beta=b6,
                  weights=k6_packed["tables"]),
             io_bytes + 4 * 7 * (E + n),
             batch * weighted_ops("layered", 6, E, n, a6, b6)),
            ("minsum_qc_flooding_w",
             dict(iterations=12, schedule="flooding", weights=w12_tables),
             io_bytes + 4 * 13 * (E + n),
             batch * weighted_ops("flooding", 12, E, n)),
            (G4_ROW, dict(iterations=20, schedule="layered",
                          layered_group=4),
             io_bytes, batch * E * edge_ops("layered", 20))):
        max_err[name] = max(max_err[name], compare(
            mq.bp_qc_cuda(llr, qc, output="posterior", **kw),
            decode_roll(llr, qc, output="posterior", **kw),
            f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, qc, **kw), 20)
        plain_ms = cuda_time_ms(lambda: decode_roll(llr, qc, **kw), 3, 1)
        kernels.append(row(name, ms, plain_ms, bound(nbytes, ops),
                           mq.entry_point(
                               qc, "min-sum", kw["schedule"],
                               weighted="weights" in kw,
                               layered_group=kw.get("layered_group", 1))))
    # the trained decoders of phase 3i: train-minsum's schedule
    # (layered-10, its α/β table) at 1.5 dB, and the neural-BP probe's
    # decode (the trained per-edge layered-6) on its BPSK channel at 2.0 dB
    ta, tb = tr3i["alpha"], tr3i["beta"]
    x20 = floor_llrs(w1944, batch, 2.0, 15)
    probe_tables = pack_decoder_weights(tr3i["edge"], w1944, 6,
                                        "cuda")["tables"]
    for name, x, kw, nbytes, ops in (
            (TRAIN_MINSUM_ROW, llr,
             dict(iterations=10, schedule="layered", alpha=ta, beta=tb),
             io_bytes, batch * E * edge_ops("layered", 10, ta, tb)),
            (TRAIN_PROBE_ROW, x20,
             dict(iterations=6, schedule="layered", weights=probe_tables),
             io_bytes + 4 * 7 * (E + n),
             batch * weighted_ops("layered", 6, E, n))):
        max_err[name] = max(max_err[name], compare(
            mq.bp_qc_cuda(x, qc, output="posterior", **kw),
            decode_roll(x, qc, output="posterior", **kw),
            f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(x, qc, **kw), 20)
        plain_ms = cuda_time_ms(lambda: decode_roll(x, qc, **kw), 3, 1)
        kernels.append(row(name, ms, plain_ms, bound(nbytes, ops),
                           mq.entry_point(qc, "min-sum", "layered",
                                          weighted="weights" in kw)))
    # phase 3j's rows. The flooding kernel on an evaluate-grid cell's three
    # LLR sets (wifi1944 flooding-20, clamp 20, 2.0 dB, a trained cell's
    # estimator), with the evaluate-grid run's launches
    kw = dict(iterations=20, schedule="flooding", clamp=20.0)
    ms = plain_ms = 0.0
    for tag, x in lib3j["grid"]["llrs"].items():
        x = x.contiguous()
        max_err[GRID_ROW] = max(max_err[GRID_ROW], compare(
            mq.bp_qc_cuda(x, qc, output="posterior", **kw),
            decode_roll(x, qc, output="posterior", **kw),
            f"{GRID_ROW} ({tag} LLRs) at batch {batch}"))
        ms += cuda_time_ms(lambda: mq.bp_qc_cuda(x, qc, **kw), 10) / 3
        plain_ms += cuda_time_ms(
            lambda: decode_roll(x, qc, **kw), 1, warmup=1) / 3
    kernels.append(row(GRID_ROW, ms, plain_ms, bound(
        io_bytes, batch * E * edge_ops(**kw)),
        mq.entry_point(qc, "min-sum", "flooding")))
    # the error-floor campaign's kernels on its first step's frames at 2.5
    # dB, each timed in the schedule named beside it (flooding-20,
    # layered-10, the committed per-edge layered-6 with its α/β), with the
    # launches of every schedule of the campaign's run
    from ldpc_sims_tpu_torch.examples.error_floor_campaign import point_llrs

    xe = point_llrs(w1944, EF_SNR, 0, 0, batch, "cuda")
    for kname, (name, sched) in FLOOR_ROWS.items():
        kw = {k: v for k, v in lib3j["floor"]["schedules"][sched].items()
              if k != "backend"}
        nbytes, ops = io_bytes, batch * E * edge_ops(
            kw["schedule"], kw["iterations"], kw.get("alpha", 1.0),
            kw.get("beta", 0.0))
        if "weights" in kw:
            kw["weights"] = kw["weights"]["tables"]
            nbytes += 4 * 7 * (E + n)
            ops = batch * weighted_ops("layered", kw["iterations"], E, n,
                                       kw["alpha"], kw["beta"])
        max_err[name] = max(max_err[name], compare(
            mq.bp_qc_cuda(xe, qc, output="posterior", **kw),
            decode_roll(xe, qc, output="posterior", **kw),
            f"{name} ({sched}) at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(xe, qc, **kw), 10)
        plain_ms = cuda_time_ms(lambda: decode_roll(xe, qc, **kw), 2, 1)
        kernels.append(row(name, ms, plain_ms, bound(nbytes, ops),
                           mq.entry_point(qc, "min-sum", kw["schedule"],
                                          weighted="weights" in kw)))
    # the flooding kernel in the DE example's measured waterfall: qc1944_r56
    # flooding-20 at batch 8192 at the measured crossing
    dcode = get_code(DE_CODE)
    dqc, kw = dcode.qc, dict(iterations=20, schedule="flooding")
    xd = floor_llrs(dcode, 8192, lib3j["de"]["snr"], 45)
    Ed = len(qc_plan(dqc)[0]) * dqc.z
    max_err[DE_ROW] = compare(
        mq.bp_qc_cuda(xd, dqc, output="posterior", **kw),
        decode_roll(xd, dqc, output="posterior", **kw),
        f"{DE_ROW} at batch 8192")
    ms = cuda_time_ms(lambda: mq.bp_qc_cuda(xd, dqc, **kw), 20)
    plain_ms = cuda_time_ms(lambda: decode_roll(xd, dqc, **kw), 2, 1)
    kernels.append(row(DE_ROW, ms, plain_ms, bound(
        8192 * dcode.n * 5, 8192 * Ed * edge_ops(**kw)),
        mq.entry_point(dqc, "min-sum", "flooding")))
    # phase 3k's rows: each kernel on its example's path with the example's
    # trained parameters, on the examples' paired BPSK frames at 2.0 dB:
    # train_minsum_1944's sum-product layered-10, tail7's layered-7 table,
    # train_edge_1944's trained flooding-12 weights and the edge-layered
    # decoder's layered-6 weights with their α/β table
    xk = floor_llrs(w1944, batch, 2.0, 61)
    t7a, t7b = (tuple(ex3k["tail7"][k]) for k in ("alpha", "beta"))
    el_packed = pack_decoder_weights(ex3k["edge_layered"], w1944, 6, "cuda")
    ela, elb = el_packed["ms_alpha"], el_packed["ms_beta"]
    per = SP_OPS_PER_EDGE_ITER["layered"] + sp_f32
    for example, kw, nbytes, ops, sfu_ops in (
            ("train_minsum_1944",
             dict(iterations=10, schedule="layered", method="sum-product"),
             io_bytes, batch * 10 * E * per, batch * 10 * E * sp_mufu),
            ("train_minsum_tail7",
             dict(iterations=7, schedule="layered", alpha=t7a, beta=t7b),
             io_bytes, batch * E * edge_ops("layered", 7, t7a, t7b), 0),
            ("train_edge_1944",
             dict(iterations=12, schedule="flooding",
                  weights=pack_decoder_weights(ex3k["edge"], w1944, 12,
                                               "cuda")["tables"]),
             io_bytes + 4 * 13 * (E + n),
             batch * weighted_ops("flooding", 12, E, n), 0),
            ("train_edge_layered_1944",
             dict(iterations=6, schedule="layered", alpha=ela, beta=elb,
                  weights=el_packed["tables"]),
             io_bytes + 4 * 7 * (E + n),
             batch * weighted_ops("layered", 6, E, n, ela, elb), 0)):
        name = EXAMPLE_ROWS[example][1]
        method = kw.get("method", "min-sum")
        max_err[name] = max(max_err[name], compare(
            mq.bp_qc_cuda(xk, qc, output="posterior", **kw),
            decode_roll(xk, qc, output="posterior", **kw),
            f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(xk, qc, **kw), 10)
        plain_ms = cuda_time_ms(lambda: decode_roll(xk, qc, **kw), 2, 1)
        kernels.append(row(name, ms, plain_ms, bound(nbytes, ops, sfu_ops),
                           mq.entry_point(qc, method, kw["schedule"],
                                          weighted="weights" in kw)))
    # sum-product layered-20 at G = 4, bound as the sum-product rows
    kw = dict(iterations=20, schedule="layered", method="sum-product",
              layered_group=4)
    max_err[SP_G4_ROW] = exact(
        [(mq.bp_qc_cuda(llr, qc, output="posterior", **kw),
          decode_roll(llr, qc, output="posterior", **kw))],
        f"{SP_G4_ROW} at batch {batch}")
    ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, qc, **kw), 10)
    plain_ms = cuda_time_ms(lambda: decode_roll(llr, qc, **kw), 2, warmup=1)
    per = SP_OPS_PER_EDGE_ITER["layered"] + sp_f32
    kernels.append(row(SP_G4_ROW, ms, plain_ms, bound(
        batch * n * 5, batch * 20 * E * per, batch * 20 * E * sp_mufu),
        mq.entry_point(qc, "sum-product", "layered", layered_group=4)))
    # the group-serial family: layered-20 at each group size, its entry
    # point, bound and the full-message group-serial kernel's time
    b_ms, b_by = bound(io_bytes, batch * E * edge_ops("layered", 20))
    for G in (1, 2, 3, 4, 6, 12):
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(
            llr, qc, iterations=20, schedule="layered", layered_group=G), 20)
        entry = mq.entry_point(qc, "min-sum", "layered", layered_group=G)
        print(f"  layered-20 G={G} at 1.5 dB ({entry}): {ms!r} ms (bound "
              f"{b_ms!r} ms, {b_by}, share {b_ms / ms:.3f}; full "
              f"messages: {FULL_MESSAGE_GROUP_MS[G]!r} ms) [{card}]",
              flush=True)
    # the full-message kernel on the codes beyond the compressed state's
    # limits: layered-20 es freeze, clamp 20, each at its phase 3d point
    # on this chain's channel LLRs, bound by the iterations it ran
    for cname, (hcode, hcfg, snr) in high_llr.items():
        name = f"minsum_qc_layered_es@{cname}"
        hqc = hcode.qc
        xh = channel_llrs(hcode, batch, snr, seed=15)
        kw = dict(iterations=20, schedule="layered", clamp=hcfg.clamp,
                  early_stop=True, es_check_every=1)
        kb, ki = mq.bp_qc_cuda(xh, hqc, output="hard_iters", **kw)
        pb, pi = decode_roll(xh, hqc, output="hard_iters", **kw)
        max_err[name] = exact([(kb, pb), (ki, pi)], f"{name} at batch {batch}")
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(xh, hqc, **kw), 10)
        plain_ms = cuda_time_ms(lambda: decode_roll(xh, hqc, **kw), 2, 1)
        ran = int(ki.sum())
        Eh = len(qc_plan(hqc)[0]) * hqc.z
        print(f"  {name} at {snr:g} dB: mean iterations {ran / batch:.4f} "
              "of 20", flush=True)
        kernels.append(row(name, ms, plain_ms, bound(
            batch * (hcode.n * 5 + 4),
            ran * Eh * edge_ops("layered", 1, clamp=hcfg.clamp)
            + (batch + ran) * Eh * OPS_PER_EDGE_CHECK),
            mq.entry_point(hqc, "min-sum", "layered", True)))
    # the error-floor point's decoders on qc1944_r56 (flooding-20,
    # layered-10) at batch 32768 on the campaign's channel, with the
    # launches of their phase 3d run, bound as the fixed min-sum rows
    fqc = fcode.qc
    Ef = len(qc_plan(fqc)[0]) * fqc.z
    xf = floor_llrs(fcode, batch, FLOOR_SNR, 44)
    for label, (_, _, kw, name) in FLOOR_FER.items():
        max_err[name] = exact(
            [(mq.bp_qc_cuda(xf, fqc, output="posterior", **kw),
              decode_roll(xf, fqc, output="posterior", **kw))],
            f"{name} at batch {batch}")
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(xf, fqc, **kw), 10)
        plain_ms = cuda_time_ms(lambda: decode_roll(xf, fqc, **kw), 2, 1)
        kernels.append(row(name, ms, plain_ms, bound(
            batch * fcode.n * 5, batch * Ef * edge_ops(**kw)),
            mq.entry_point(fqc, "min-sum", kw["schedule"])))
    # the wide rows' group-serial min-sum and sum-product forms (the _gw and
    # _rw kernels) at the rows of kernels/compare.py, each exactly equal
    # to the plain version (sum-product's posteriors within the
    # tolerance), with the launches of its phase 3d run, beside the
    # full-message kernel's time; the early-stop rows bound by the
    # iterations they ran. A kernel with a stack frame fails unless it runs
    # faster than the full-message kernel.

    for name, (cname, want, _) in WIDE_ROWS.items():
        wcode = get_code(cname)
        wqc, nw = wcode.qc, wcode.n
        Ew = len(qc_plan(wqc)[0]) * wqc.z
        xw = channel_llrs(wcode, batch, TPU_AT[cname], seed=15)
        kw = dict(want, schedule=want.get("schedule", "layered"))
        sp = kw.get("method") == "sum-product"
        es = kw.get("early_stop", False)
        nbytes, extra = batch * nw * 5, 0
        if kw.pop("weights", False):
            kw["weights"] = pack_decoder_weights(random_edge_weights(
                wcode, 6, seed=53), wcode, 6, "cuda")["tables"]
            nbytes += 4 * 7 * (Ew + nw)  # the weight tables, read once
        if es:
            kb, ki = mq.bp_qc_cuda(xw, wqc, output="hard_iters", **kw)
            pb, pi = decode_roll(xw, wqc, output="hard_iters", **kw)
            max_err[name] = exact([(kb, pb), (ki, pi)],
                                  f"{name} at batch {batch}")
        elif sp:
            max_err[name] = compare(
                mq.bp_qc_cuda(xw, wqc, output="posterior", **kw),
                decode_roll(xw, wqc, output="posterior", **kw),
                f"{name} at batch {batch}")
        else:
            max_err[name] = exact(
                [(mq.bp_qc_cuda(xw, wqc, output="posterior", **kw),
                  decode_roll(xw, wqc, output="posterior", **kw))],
                f"{name} at batch {batch}")
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(xw, wqc, **kw), 10)
        plain_ms = cuda_time_ms(lambda: decode_roll(xw, wqc, **kw), 2, 1)
        sched, its = kw["schedule"], kw["iterations"]
        ran = int(ki.sum()) if es else batch * its
        if es:
            nbytes += batch * 4  # the iteration counts
            extra = (batch + ran) * Ew * OPS_PER_EDGE_CHECK
            print(f"  {name}: mean iterations {ran / batch:.4f} of {its}",
                  flush=True)
        if sp:
            per = SP_OPS_PER_EDGE_ITER[sched] + sp_f32
            bnd = bound(nbytes, ran * Ew * per + extra, ran * Ew * sp_mufu)
        elif "weights" in kw:
            bnd = bound(nbytes, batch * weighted_ops(sched, its, Ew, nw))
        else:
            bnd = bound(nbytes, ran * Ew * edge_ops(sched, 1) + extra)
        entry = mq.entry_point(wqc, kw.get("method", "min-sum"), sched, es,
                               False, "weights" in kw,
                               layered_group=kw.get("layered_group", 1))
        kernels.append(row(name, ms, plain_ms, bnd, entry))
        print(f"  {name}: share of the bound {bnd[0] / ms:.3f}, "
              f"{FULL_MESSAGE_MS[name] / ms:.3f}x the full-message kernel",
              flush=True)
        if wide_stack.get(entry) and not ms < FULL_MESSAGE_MS[name]:
            fail(f"{name}: {entry} has a {wide_stack[entry]} B stack frame "
                 f"and runs {ms} ms, not below the full-message "
                 f"{FULL_MESSAGE_MS[name]} ms")
    # the drivers against plain compositions of their passes, at 2.5 dB
    # (where the probe overflows) and 3.0 dB (its compact path), each
    # bound by the iterations and checks its passes ran
    es = dict(schedule="layered", early_stop=True, output="hard_iters")

    def plain_requeue(x):
        b1, i1 = decode_roll(x, qc, iterations=4, **es)
        done = i1 < 4
        b2, i2 = decode_roll(x, qc, iterations=20, done_in=done, **es)
        return (torch.where(done[:, None], b1, b2),
                torch.where(done, i1, 4 + i2))

    def plain_probe(x):
        b1, u = decode_roll(x, qc, iterations=4, schedule="layered",
                            output="hard_unsat")
        done = u == 0
        keep = done & (batch - int(done.sum()) <= mq.probe_capacity(batch))
        b2 = decode_roll(x, qc, done_in=keep, **full)
        return torch.where(keep[:, None], b1, b2)

    for snrdb, x in ((2.5, llr25), (3.0, llr30)):
        at = f"at {snrdb:g} dB [{card}]"
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(x, qc, **full), 20)
        print(f"  fixed layered-20 {at}: {ms!r} ms", flush=True)
        _, it = mq.bp_qc_cuda(x, qc, **full, early_stop=True,
                              output="hard_iters")
        ran = int(it.sum())
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(x, qc, early_stop=True,
                                                **full), 20)
        b_ms, b_by = bound(io_bytes + batch * 4,
                           ran * per_it + (batch + ran) * per_check)
        print(f"  layered-20 es freeze {at}: {ms!r} ms (bound {b_ms!r} ms, "
              f"{b_by})", flush=True)
        _, it = mq.bp_qc_requeue(x, qc, 20, probe_iters=4, es_check_every=1,
                                 schedule="layered", output="hard_iters")
        ran = int(it.sum())  # probe and second pass together
        ms = cuda_time_ms(lambda: mq.bp_qc_requeue(
            x, qc, 20, probe_iters=4, es_check_every=1,
            schedule="layered"), 20)
        plain_ms = cuda_time_ms(lambda: plain_requeue(x), 3, 1)
        b_ms, b_by = bound(io_bytes + batch * 4,
                           ran * per_it + (batch + ran) * per_check)
        print(f"  bp_qc_requeue K=1 {at}: {ms!r} ms (plain {plain_ms!r} ms, "
              f"bound {b_ms!r} ms, {b_by})", flush=True)
        _, it = mq.bp_qc_probe_requeue(x, qc, 20, probe_iters=4,
                                       output="hard_iters")
        redo = int((it > 4).sum())
        ms = cuda_time_ms(lambda: mq.bp_qc_probe_requeue(
            x, qc, 20, probe_iters=4), 20)
        plain_ms = cuda_time_ms(lambda: plain_probe(x), 3, 1)
        b_ms, b_by = bound(io_bytes, batch * (4 * per_it + per_check)
                           + redo * 20 * per_it)
        print(f"  bp_qc_probe_requeue {at}, {redo} of {batch} re-decoded: "
              f"{ms!r} ms (plain {plain_ms!r} ms, bound {b_ms!r} ms, "
              f"{b_by})", flush=True)

    # the storage rows: trained layered-8 on wifi1944 at bf16 and int8,
    # beside minsum_qc_layered, then the bigcode shapes on qc12288 at
    # batch 16384; launches from phase 3e (one a decode). The bound adds
    # the conversions a layered edge needs per iteration: bf16 lifts the
    # message and the posterior and stores both; int8 lifts the old and
    # the stored new message and stores one (its posterior is f32)
    cv = {k: ins[f"probe_{k}"][2] - ins["probe_copy"][2]
          for k in ("ld_bf16", "st_bf16", "ld_i8", "st_i8")}
    print(f"  SASS conversion instructions per load/store (beyond a plain "
          f"f32 copy): {cv}", flush=True)
    conv_ops = {torch.float32: 0,
                torch.bfloat16: 2 * cv["ld_bf16"] + 2 * cv["st_bf16"],
                torch.int8: 2 * cv["ld_i8"] + cv["st_i8"]}
    kw8 = dict(iterations=8, schedule="layered", alpha=a8, beta=b8)
    for dt, sfx in storage_rows.items():
        name = f"minsum_qc_layered@{sfx}"
        kname = mq.kernel_name("min-sum", "layered", dtype=dt)
        kw = dict(kw8, dtype=dt, msg_qclip=24.0)
        max_err[name] = max(max_err[kname], exact(
            [(mq.bp_qc_cuda(llr, qc, output="posterior", **kw),
              decode_roll(llr, qc, output="posterior", **kw))],
            f"{name} at batch {batch}"))
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, qc, **kw), 20)
        plain_ms = cuda_time_ms(lambda: decode_roll(llr, qc, **kw), 3, 1)
        launches[name] = sum(c[kname] for c in big_launch.values())
        per_step[name] = 1.0
        kernels.append(row(name, ms, plain_ms, bound(
            io_bytes, batch * E * (edge_ops(**kw8) + 8 * conv_ops[dt])),
            mq.entry_point(qc, "min-sum", "layered", dtype=dt)))
    bqc = big.qc
    E_big = len(qc_plan(bqc)[0]) * bqc.z
    gen = torch.Generator(device="cuda")
    gen.manual_seed(61)
    xb = torch.randn((big_batch, big.n), generator=gen,
                     device="cuda") * 2.0 - 4.0
    for name, kname, kw in (
            ("minsum_qc_flooding@qc12288",
             mq.kernel_name("min-sum", "flooding"),
             dict(iterations=20, schedule="flooding")),
            *(("minsum_qc_layered@qc12288" + ("" if sfx == "f32" else
                                               f"-{sfx}"),
               mq.kernel_name("min-sum", "layered", dtype=dt),
               dict(iterations=10, schedule="layered", dtype=dt,
                    msg_qclip=24.0))
              for dt, sfx in {torch.float32: "f32",
                              **storage_rows}.items())):
        max_err[name] = exact(
            [(mq.bp_qc_cuda(xb, bqc, output="posterior", **kw),
              decode_roll(xb, bqc, output="posterior", **kw))],
            f"{name} at batch {big_batch}")
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(xb, bqc, **kw), 10)
        plain_ms = cuda_time_ms(lambda: decode_roll(xb, bqc, **kw), 1, 1)
        launches[name] = big_launch["qc12288_r12"][kname]
        per_step[name] = 1.0
        it = kw["iterations"]
        ops = edge_ops(kw["schedule"], it) + it * conv_ops[
            kw.get("dtype", torch.float32)]
        kernels.append(row(name, ms, plain_ms, bound(
            big_batch * big.n * 5, big_batch * E_big * ops),
            mq.entry_point(bqc, "min-sum", kw["schedule"],
                           dtype=kw.get("dtype", torch.float32))))
    # the min-sum flooding forms that no main path launches, printed with
    # their bounds (no row: no main-path run launches them): flooding-20 on
    # wifi1944 at bf16 and int8 (a flooding edge stores and lifts its v2c
    # and its message each iteration), with its unsatisfied-check count, and
    # over the codewords a flooding probe-4 leaves unsatisfied at 3.5 dB
    fl = dict(iterations=20, schedule="flooding")
    for dt, sfx in storage_rows.items():
        k = "bf16" if dt == torch.bfloat16 else "i8"
        kw = dict(fl, dtype=dt, msg_qclip=24.0)
        exact([(mq.bp_qc_cuda(llr, qc, output="posterior", **kw),
                decode_roll(llr, qc, output="posterior", **kw))],
              f"flooding-20 {sfx} at batch {batch}")
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, qc, **kw), 20)
        plain_ms = cuda_time_ms(lambda: decode_roll(llr, qc, **kw), 2, 1)
        b_ms, b_by = bound(io_bytes, batch * E * (
            edge_ops(**fl) + 20 * 2 * (cv[f"ld_{k}"] + cv[f"st_{k}"])))
        print(f"  minsum_qc_flooding@{sfx} "
              f"({mq.entry_point(qc, 'min-sum', 'flooding', dtype=dt)}): "
              f"{ms!r} ms (plain {plain_ms!r} ms, bound {b_ms!r} ms, "
              f"{b_by}) [{card}]", flush=True)
    kb, ku = mq.bp_qc_cuda(llr, qc, output="hard_unsat", **fl)
    pb, pu = decode_roll(llr, qc, output="hard_unsat", **fl)
    exact([(kb, pb), (ku, pu)], f"flooding-20 hard_unsat at batch {batch}")
    ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, qc, output="hard_unsat",
                                            **fl), 20)
    b_ms, b_by = bound(io_bytes + batch * 4, batch * E * (
        edge_ops(**fl) + OPS_PER_EDGE_CHECK))
    print(f"  minsum_qc_flooding@hard_unsat: {ms!r} ms (bound {b_ms!r} ms, "
          f"{b_by}) [{card}]", flush=True)
    _, ku = mq.bp_qc_cuda(llr35, qc, iterations=4, output="hard_unsat")
    done = ku == 0
    todo = batch - int(done.sum())
    exact([(mq.bp_qc_cuda(llr35, qc, done_in=done, **fl)[~done],
            decode_roll(llr35, qc, done_in=done, **fl)[~done])],
          f"flooding-20 done_in at batch {batch}")
    ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr35, qc, done_in=done, **fl),
                      20)
    b_ms, b_by = bound(todo * n * 5 + batch * 4, todo * E * edge_ops(**fl))
    print(f"  minsum_qc_flooding@done_in ({todo} of {batch} decoded after a "
          f"flooding probe-4 at 3.5 dB): {ms!r} ms (bound {b_ms!r} ms, "
          f"{b_by}) [{card}]", flush=True)
    # the error-floor campaign's decoders on the high-rate codes (the wide
    # word's kernels), printed with their bounds (no row: no main path
    # launches them): flooding-20, layered-10 and the probe driver (4 probe
    # iterations, 20 in all) at each campaign's first SNR, batch 32768, each
    # exactly equal to the plain version; then flooding-20 and layered-20
    # at bf16 and int8 on qc1944_r56 (the storage rows' conversions)
    for cname, snr in FLOOR_SHAPES.items():
        c = get_code(cname)
        cq = c.qc
        Ec = len(qc_plan(cq)[0]) * cq.z
        x = floor_llrs(c, batch, snr, 45)
        c_bytes = batch * c.n * 5
        for label, kw in (("flooding-20", fl),
                          ("layered-10", dict(iterations=10,
                                              schedule="layered"))):
            exact([(mq.bp_qc_cuda(x, cq, output="posterior", **kw),
                    decode_roll(x, cq, output="posterior", **kw))],
                  f"{cname} {label} at batch {batch}")
            ms = cuda_time_ms(lambda: mq.bp_qc_cuda(x, cq, **kw), 10)
            b_ms, b_by = bound(c_bytes, batch * Ec * edge_ops(**kw))
            print(f"  {cname} {label} @ {snr:g} dB "
                  f"({mq.entry_point(cq, 'min-sum', kw['schedule'])}): "
                  f"{ms!r} ms (bound {b_ms!r} ms, {b_by}, share "
                  f"{b_ms / ms:.3f}) [{card}]", flush=True)
        # the probe driver, bound by the iterations its passes ran
        pb_, pit = mq.bp_qc_probe_requeue(x, cq, 20, probe_iters=4,
                                          output="hard_iters")
        b1, u1 = decode_roll(x, cq, iterations=4, schedule="layered",
                             output="hard_unsat")
        keep = (u1 == 0) & (batch - int((u1 == 0).sum())
                            <= mq.probe_capacity(batch))
        exact([(pb_, torch.where(keep[:, None], b1, decode_roll(
            x, cq, iterations=20, schedule="layered")))],
            f"{cname} bp_qc_probe_requeue at batch {batch}")
        redo = int((pit > 4).sum())
        ms = cuda_time_ms(lambda: mq.bp_qc_probe_requeue(
            x, cq, 20, probe_iters=4), 10)
        c_it = Ec * edge_ops("layered", 1)
        b_ms, b_by = bound(c_bytes, batch * (
            4 * c_it + Ec * OPS_PER_EDGE_CHECK) + redo * 20 * c_it)
        print(f"  {cname} probe-plain4-20 @ {snr:g} dB, {redo} of {batch} "
              f"re-decoded: {ms!r} ms (bound {b_ms!r} ms, {b_by}, share "
              f"{b_ms / ms:.3f}) [{card}]", flush=True)
    for dt, sfx in {torch.float32: "f32", **storage_rows}.items():
        k = {torch.bfloat16: "bf16", torch.int8: "i8"}.get(dt)
        for label, kw, ops in (
                ("flooding-20", dict(fl, dtype=dt, msg_qclip=24.0),
                 edge_ops(**fl) + (20 * 2 * (cv[f"ld_{k}"] + cv[f"st_{k}"])
                                   if k else 0)),
                ("layered-20", dict(iterations=20, schedule="layered",
                                    dtype=dt, msg_qclip=24.0),
                 edge_ops("layered", 20) + 20 * conv_ops[dt])):
            if label == "flooding-20" and dt == torch.float32:
                continue  # the minsum_qc_flooding@qc1944_r56 row
            exact([(mq.bp_qc_cuda(xf, fqc, output="posterior", **kw),
                    decode_roll(xf, fqc, output="posterior", **kw))],
                  f"{FLOOR_CODE} {label} {sfx} at batch {batch}")
            ms = cuda_time_ms(lambda: mq.bp_qc_cuda(xf, fqc, **kw), 10)
            b_ms, b_by = bound(batch * fcode.n * 5, batch * Ef * ops)
            entry = mq.entry_point(fqc, "min-sum", kw["schedule"], dtype=dt)
            print(f"  {FLOOR_CODE} {label} {sfx} @ {FLOOR_SNR:g} dB "
                  f"({entry}): {ms!r} ms (bound {b_ms!r} ms, {b_by}, share "
                  f"{b_ms / ms:.3f}) [{card}]", flush=True)
    # the sum-product forms that no main path launches, printed with their
    # plain version's time and their bounds: per-edge weights (12 iterations, flooding-12's random
    # weights), 4-bit messages, bf16 and int8 storage (20 iterations), each
    # schedule, each exactly equal to the plain version; the weights add
    # their multiplies as weighted_ops counts them, the quantization its
    # SASS count, the storage its conversions (a layered edge lifts and
    # stores its message and posterior, a flooding edge its v2c and its
    # message)
    sp_cv = {torch.bfloat16: {"layered": 2 * cv["ld_bf16"] + 2 * cv["st_bf16"],
                              "flooding": 2 * (cv["ld_bf16"]
                                               + cv["st_bf16"])},
             torch.int8: {"layered": 2 * cv["ld_i8"] + cv["st_i8"],
                          "flooding": 2 * (cv["ld_i8"] + cv["st_i8"])}}
    for sched in ("flooding", "layered"):
        per = SP_OPS_PER_EDGE_ITER[sched] + sp_f32
        sp = dict(schedule=sched, method="sum-product")
        for label, kw, ops, sfu in (
                ("_w", dict(iterations=12, weights=w12_tables),
                 E * 12 * (per + (2 if sched == "flooding" else 4))
                 + n * 13, E * 12 * sp_mufu),
                ("@msgq4", dict(iterations=20, msg_qbits=4),
                 E * 20 * (per + q_f32), E * 20 * (sp_mufu + q_mufu)),
                *((f"@{sfx}", dict(iterations=20, dtype=dt, msg_qclip=24.0),
                   E * 20 * (per + sp_cv[dt][sched]), E * 20 * sp_mufu)
                  for dt, sfx in storage_rows.items())):
            kw = dict(sp, **kw)
            name = f"sumproduct_qc_{sched}{label}"
            exact([(mq.bp_qc_cuda(llr, qc, output="posterior", **kw),
                    decode_roll(llr, qc, output="posterior", **kw))],
                  f"{name} at batch {batch}")
            ms = cuda_time_ms(lambda: mq.bp_qc_cuda(llr, qc, **kw), 10)
            plain_ms = cuda_time_ms(lambda: decode_roll(llr, qc, **kw), 2, 1)
            nbytes = io_bytes + (4 * 13 * (E + n) if label == "_w" else 0)
            b_ms, b_by = bound(nbytes, batch * ops, batch * sfu)
            entry = mq.entry_point(qc, "sum-product", sched,
                                   quantized="msg_qbits" in kw,
                                   weighted="weights" in kw,
                                   dtype=kw.get("dtype", torch.float32))
            print(f"  {name} ({entry}): {ms!r} ms (plain {plain_ms!r} ms, "
                  f"bound {b_ms!r} ms, {b_by}, share {b_ms / ms:.3f}) "
                  f"[{card}]", flush=True)
    # the other forms of the _lw kernels (LW_ROWS), at the shape phase 3d
    # decoded them (qc1944_r56's TPU-sweep point, batch 32768), each exactly
    # equal to the plain version, whose one run is its time; bound as the
    # sum-product rows above, early stop by the iterations it ran and its
    # syndrome checks
    lqc = lw_code.qc
    Elw, nlw = len(qc_plan(lqc)[0]) * lqc.z, lw_code.n
    lw_tables = pack_decoder_weights(lw_w, lw_code, 12, "cuda")["tables"]
    for name, (form, dsfx) in LW_ROWS.items():
        kw = lw_kwargs(form, dsfx, lw_tables)
        es = kw.get("early_stop", False)
        out = "hard_iters" if es else "posterior"
        got = mq.bp_qc_cuda(lw_x, lqc, output=out, **kw)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = decode_roll(lw_x, lqc, output=out, **kw)
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        max_err[name] = exact(list(zip(got, want)) if es else [(got, want)],
                              f"{name} at batch {batch}")
        ms = cuda_time_ms(lambda: mq.bp_qc_cuda(lw_x, lqc, **kw), 10)
        ran = int(got[1].sum()) if es else batch * kw["iterations"]
        dt = kw["dtype"]
        per = (SP_OPS_PER_EDGE_ITER["flooding"] + sp_f32
               + (q_f32 if "msg_qbits" in kw else 0)
               + (sp_cv[dt]["flooding"] if dt != torch.float32 else 0)
               + (2 if "weights" in kw else 0))
        mufu = sp_mufu + (q_mufu if "msg_qbits" in kw else 0)
        nbytes = batch * nlw * 5 + (batch * 4 if es else 0) + (
            4 * 13 * (Elw + nlw) if "weights" in kw else 0)
        extra = ((batch + ran) * Elw * OPS_PER_EDGE_CHECK if es else 0) + (
            batch * nlw * 13 if "weights" in kw else 0)
        kernels.append(row(name, ms, plain_ms,
                           bound(nbytes, ran * Elw * per + extra,
                                 ran * Elw * mufu), lw_entry(lw_code, kw)))
    # the shared-memory instructions of min-sum, serial-C and flooding,
    # both designs each. Serial-C: the full-message edge loops are unrolled
    # by 4 (a pass-1 loop of 4 loads an edge, a pass-2 loop of 4 loads and 2
    # stores an edge) beside 2 row_ptr loads a check; the compressed check
    # body is unrolled over its 8 slots, d + 2 loads and d + 2 stores at
    # degree d. Flooding: the full-message check loops load 4 an edge (pass
    # 1) and 4 with 1 store (pass 2) beside 2 row_ptr loads a check, and the
    # rebuild loads 3 an edge beside 2 col_ptr loads and a store a
    # variable; the compressed check pass holds one body for each degree
    # 1-8 in its loop (d + 2 loads and 2 stores at degree d: 52 and 16 in
    # all), and the rebuild loop 2 loads an edge beside an LLR load and a
    # posterior store a variable. Sum-product with full messages: the same
    # loads and stores as min-sum's full-message loops, and a local store
    # (the row's lt) an edge in pass 1 and a local load in pass 2; with a
    # check's slots in registers, one loop holds the bodies of degrees 1-8
    # (36 slots): serial-C 2 loads (message, posterior) and 2 stores an
    # edge, 144 in all; flooding 2 loads and 1 store an edge, 108 in all,
    # and its rebuild 1 load an edge beside an LLR load and a posterior
    # store a variable; no plan load (the parameter) and no local memory
    d_bar = len(qc_plan(w1944.qc)[0]) / w1944.qc.mb
    v_bar = E / n  # edges a variable
    loops_by_design, sizes = smem_instructions(lib)
    for design, loops in loops_by_design.items():
        print(f"  SASS innermost loops of the f32 kernel, {design} design "
              f"({sizes[design]} instructions in all; instructions, LDS, "
              f"STS, LDL + STL): {loops}", flush=True)
    cs_deg = mq.COMPRESSED_LIMITS[0]
    print(f"  shared-memory instructions an edge at wifi1944's mean row "
          f"degree {d_bar:.3f} and {v_bar:.3f} edges a variable: serial-C "
          f"full messages {4 + 6 + 2 / d_bar:.3f}, compressed "
          f"{2 + 4 / d_bar:.3f} (from loops of 4 x (4 + 0) and 4 x (4 + 2), "
          f"and of {cs_deg + 2} + {cs_deg + 2} for {cs_deg} slots); "
          f"flooding full messages {4 + 5 + 2 / d_bar + 3 + 3 / v_bar:.3f}, "
          f"compressed {1 + 4 / d_bar + 2 + 2 / v_bar:.3f}; sum-product "
          f"serial-C full messages {4 + 6 + 2 / d_bar:.3f} (+ 2 local), "
          f"registers {2 + 2:.3f}; sum-product flooding full messages "
          f"{4 + 5 + 2 / d_bar + 3 + 3 / v_bar:.3f} (+ 2 local), registers "
          f"{2 + 1 + 1 + 2 / v_bar:.3f}", flush=True)
    # the wide word on qc1944_r56 (rows of degree 17-18): serial-C as the
    # compressed design, d + 2 loads and d + 2 stores a check of degree d;
    # flooding d + 2 loads and 2 stores a check, 2 loads an edge and 2 a
    # variable in the rebuild; the full messages as on wifi1944
    d_w = len(qc_plan(fqc)[0]) / fqc.mb
    v_w = Ef / fcode.n
    print(f"  shared-memory instructions an edge at qc1944_r56's mean row "
          f"degree {d_w:.3f} and {v_w:.3f} edges a variable: serial-C full "
          f"messages {4 + 6 + 2 / d_w:.3f}, compressed-wide "
          f"{2 + 4 / d_w:.3f}; flooding full messages "
          f"{4 + 5 + 2 / d_w + 3 + 3 / v_w:.3f}, compressed-wide "
          f"{1 + 4 / d_w + 2 + 2 / v_w:.3f}", flush=True)
    # one short sweep of the launch tuner
    from ldpc_sims_tpu_torch.kernels import tune

    for sched, ths in (("flooding", (128, 256, 512)), ("layered", (None,))):
        for th in ths:
            for dt in ("float32", "bfloat16", "int8"):
                r = tune.time_config(w1944, 8192, 10, th, dt, steps=3,
                                     schedule=sched)
                print(f"  tune {json.dumps(r)}", flush=True)

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
