#!/usr/bin/env python3
"""Drive the PyTorch port (``svs_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --loss-times TREE   # loss kernels of TREE only

Phases, each printing what it found on its own line:

1. device  — the card's name and its ``nvidia-smi`` name / power limit;
2. build   — nvcc builds every hand-written kernel library from
             ``svs_torch/csrc`` (one nvcc per source, all started together);
2b. clocks — the device phase clock (``profiling.mark``,
             ``svs_torch/csrc/phase_clock.cu``): the kernel's arithmetic
             against its plain version ``profiling._clock_plain`` fed the
             stamps the kernel wrote (201 eager launches of seeded slots,
             ``begin`` among them, the buffer the same int64s after each);
             a graph of ``begin`` and two marks around chains of 4 and 8
             float32 matmuls replayed 50 times with no synchronise: each
             slot counts exactly 50, the phases' sum within 1 % of CUDA
             events around the replays, each phase within 3 % of its work's
             CUDA events outside any graph; the us a mark costs a replay
             (1,000 marks in a graph) and the ns a span costs the host with
             no profiler (plain and ``always``); one ``clocks:`` JSON line;
3. kernels — each kernel against its plain PyTorch version on the card
             (TF32 off) at the main paths' shapes.  The front ends
             ``stft_magphase`` and ``stft_magnitude`` on both FFT routes:
             the fft kernel at the decode shapes, at ``bench_cli
             --frontend``'s 240-s signal, at hop 256 and at n_fft 2048 and
             4096, the mixed kernel on a 4-minute song at n_fft 1000, 1536,
             441 (odd), 999 (odd, Bluestein), 1018 (Bluestein) and 8192,
             and the zero signal at n_fft 1024, 1000 and 999; timed by
             device time (torch.profiler) beside their plain versions,
             ``torch.stft`` + ``abs`` and, at an even n_fft, the gemm
             kernel (the earlier design) at the same shapes.  The four
             MR-STFT loss kernels (``spectral_mag`` and
             ``loss_partials``, forward and backward) at the train
             step's shapes (B = 32, 97,536 samples, all three resolutions),
             the pp phase's microbatch (B = 8), a two-host step's rank
             (B = 16), the cp phase's whole batch
             (B = 4, 392,960 samples), a ragged shape and a weighted batch;
             timed (at the train step's shapes) by device time
             (torch.profiler) summed over their own ``spec::`` kernels,
             each backward's two launches apart, and by CUDA events
             (``event_ms``); ``ptxas -v`` of the loss kernels printed once;
             then the four loss kernels at a geometry past each limit they
             once had (n_fft % 128, an odd hop, an odd n_fft, signal spans
             past a block's shared memory, the adjoint's 600 shifts at hop
             2), against their plain versions, timed by CUDA events;
4. slice   — the decode path through the CLIs a user calls, at the full
             width of the ``default`` preset (bf16, seeded random weights
             saved as a reference ``.pth``): ``data_cli --direction to_spec``
             -> ``infer_cli`` -> ``data_cli --direction to_wave`` on three
             synthetic 60-s songs; the kernels' launch counts are zeroed
             just before and read just after (every front-end launch on
             the fft route); one song's bf16 masks held
             against the same weights and input on the CPU; then
             ``separate_wav`` timed, with one torch.profiler trace of its
             device time by family; then the ``decode graph`` check: the
             decode as cached captured programs (``infer/graphs.py``) on a
             60-s and a 4-minute song, each replay against the eager body
             (``_separate_padded``) bit for bit in the ``segments``,
             ``overlap`` and ``whole`` modes, with ``vocal_solo`` off,
             ``both=True`` and PCM16 (0 LSB), and through the entry
             points; ms a call of ``separate_wav`` and of the padded
             decode on the card, graph and eager (CUDA events, 5 calls),
             the first call's warm-up and capture, the busy and idle share
             of one traced call each, the bytes of each program and of the
             cache, and a rebound model captured again; one ``decode
             graph:`` JSON line;
5. serve   — ``python -m svs_torch.cli.serve_cli`` in its own process on
             the slice's ``.pth`` (60-s warmup on its worker thread), driven
             over HTTP: 50 serial requests of one 60-s song, a burst of 8
             distinct songs (``vocal_solo=0``, ``mode=segments``,
             ``mode=whole`` and a 44.1-kHz stereo WAV among them), each
             response held against ``separate_wav`` in this process (1 LSB;
             both run the cached program, whose bits the slice phase holds
             against the eager body), ``/healthz``'s counts and
             percentiles, the 404 / 400 / 411 / 413 paths, SIGTERM during
             a second burst (200 or 503 only, exit 0); then ``amplitude_to_db`` on the card against the CPU and
             ``viz_cli --device cuda`` (a figure where matplotlib imports,
             else an ImportError that names it); one ``serve:`` JSON line
             (serial p50 / p90, the burst's throughput over its 8192-Hz
             songs and the 44.1-kHz song's latency apart, coalescing, the
             percentiles, a serial request's device share from a trace of
             its one-song stream call, and one in-process stream call of
             the burst's songs for scale);
6. train   — the training path on the slice's spectra: ``PatchDataset``
             batches of 32, one seeded full-width ``default`` state, four
             steps from it under each of ``matmul_bf16`` (on the card the
             loss kernels' rounded instances), ``pallas_fused``,
             ``pallas_fused_wide`` and ``pallas_bf16``, and under
             ``matmul_bf16`` with its route to the kernels refused (the
             PyTorch composition, which runs no loss kernel), through
             ``make_train_step``'s cached program (the first its eager
             warm-up step, the second its capture; counts zeroed just
             before each and read just after), ms per call from CUDA
             events, and the device's busy share and the loss kernels'
             launches of one more replayed step from a torch.profiler
             trace; each kernel path's first-step loss and gradient norm
             against the composition's;
7. bench   — the bench entry point: ``bench_cli --frontend`` (counts
             zeroed just before and read just after: 102 launches of each
             front-end kernel, all on the fft route), then the default
             line ``bench_cli --secs 60 --reps 2``
             at the ``default`` preset (PCM16 stream, device-resident
             decode as the replay and as the eager body, the train step at B = 32, the epoch with
             the host pipeline and with the dataset on the card), every
             number finite and positive, and no train FLOPs or MFU (the
             loss kernels, which the FLOP counter cannot see, run in the
             step); one song of the PCM16 stream held
             against ``separate_wav`` (2 LSB), and ``DeviceDataset``
             batches on the card against the host ``PatchDataset``'s
             (bitwise);
8. fit     — the training entry point at the full ``default`` preset
             (B = 32, bf16 convs, seeded weights): ``train_cli`` for two
             epochs with validation on the slice's spectra (log, metrics and
             checkpoints checked), a resume from its ``.ckpt`` for a third,
             ``infer_cli`` separating a song from that ``.ckpt``, one epoch of
             ``fit`` under each of ``matmul_bf16``, ``pallas_fused``,
             ``pallas_bf16`` and the composition without dropout, traced
             by torch.profiler (the loss kernels' counts zeroed just
             before each and read just after: the program's warm-up step
             and capture, the replays' launches from the trace; the kernel
             paths' mean loss against the composition's), one epoch
             traced for the device's idle
             share, and one ``fine_tune`` step with remat against the same
             step without it;
8b. step graph — ``make_train_step`` / ``make_eval_step`` as cached
             captured programs (``train/graphs.py``) at the full
             ``default`` preset, B = 32, under ``matmul_bf16``,
             ``pallas_bf16`` and ``pallas_fused``: four program calls and a
             ragged tail of 20, twice, against the eager body from one
             seeded state (metrics, parameters, BN and Adam the same bits),
             the eval programs at B = 32 and 20 against the eager eval;
             accumulation over 2 (both positions), a weighted batch, a
             learning-rate change (captured again), the ``fine_tune``
             preset with remat (B = 4 x 1,536 frames) and a float32 step
             under cuDNN's deterministic algorithms, each the same bits;
             the step's ms as replay and as eager body (CUDA events), a
             traced replay's busy ms, idle share and loss-kernel launches,
             the first call's and the capture's seconds, each program's
             bytes and the cache's; then two epochs of ``fit`` with
             validation and a tail, its steps as programs, against the same
             fit with the eager bodies (step losses, text log and final
             state the same bits) and their epoch seconds; one ``step
             graph:`` JSON line;
9. scan    — ``fit(epoch_scan=True)`` (each epoch's full batches as replays
             of one captured CUDA graph of the step) at the full ``default``
             preset, B = 32, 35 patches a song (3 full steps and a ragged
             tail an epoch), 2 epochs across a learning-rate drop, under
             each of ``matmul_bf16``, ``pallas_bf16`` and ``pallas_fused``
             with ``val_sdr``, against the per-step fit (its steps
             ``make_train_step``'s cached programs, the same capturable
             Adam): per-step losses and parameters bit for bit, captures
             and replays, the loss kernels' wrapper counts (eager launches
             and calls recorded into a graph, zeroed just before, read just
             after) and their launches in the fit's replays (the fit traced
             by torch.profiler); then, after the counts are read, the
             step's ms with and without the graph (CUDA events) and the
             idle share of a traced graph epoch; then SIGTERM (exit 143) at
             the first epoch and the resume from its ``.ckpt`` against the
             uninterrupted fit, and ``accum_steps = 2`` with augmentation;
10. native — the port's C++ loader: native batches bitwise equal to numpy's,
             an epoch of batches timed with each, and a ``train_cli`` epoch
             with ``'auto'`` resolved to native;
11. eval   — ``eval_cli --impl torch`` (BSS eval in float64 on the card)
             against ``--impl numpy`` on the slice's separated wavs, and
             ``validation_sdr`` of one song on the card against the host's
             BSS, no fallback;
12. dp     — the data-parallel layer (``svs_torch.parallel``): ``make_mesh``
             alone makes a world of one over NCCL, and the full-width
             ``default`` DP step at B = 32 under ``pallas_fused`` and
             ``pallas_bf16`` (the loss kernels' counts zeroed just before
             and read just after) is held against ``make_train_step`` on
             the same batch with an all-ones ``weight`` (the same bits,
             and within ``__graft_entry__``'s envelope), both timed by
             CUDA events, each as its program and its eager body; the DP
             train and eval steps as cached programs
             (``layout_programs``) against their eager bodies
             (``step.eager``) under ``matmul_bf16``, ``pallas_bf16`` and
             ``pallas_fused``: two full batches, a batch of 24 rows padded
             to 32 and a ragged tail of 20 twice, the same bits (metrics,
             parameters, BN, Adam), the eval programs on a full and a
             padded tail batch too, replay and eager ms (CUDA
             events), a traced replay's idle share and loss-kernel
             launches, the warm-up and capture calls' seconds, each
             program's bytes, and the loss kernels' launches of the calls
             (eager, captured, replayed from a trace); two epochs of a
             programmed ``fit`` against the eager ``fit``, bit for bit
             (``layout_fit_programs``); the DP program's replay beside the
             single step program's, unweighted and with the all-ones
             ``weight``, in turns (``program_turns``);
             ``separate_magnitude_mesh`` of a 4-minute song's
             magnitude (float32) against ``separate_magnitude``, each
             rank's SP mask as its decode program against its eager body
             bit for bit (cuDNN deterministic) and both timed in turns;
             then
             whether NCCL runs two ranks on one card (a pool of two worker
             processes: its all-reduce must then be right, and the one
             refusal taken is NCCL's duplicate GPU), and two ranks on the card (gloo with CUDA tensors where NCCL
             refuses) stepping B = 2 x 16 of the float32 ``default`` model
             against the single-process B = 32 step, the ranks' states the
             same bits, no program built over gloo, and the SP decode
             on the two ranks, each rank's mask program its eager body's
             bits; any failure fails the run;
13. dpscan — ``epoch_scan`` over a data-parallel mesh, cuDNN deterministic:
             the scan phase's fit (``default`` preset, B = 32, 3 full steps
             and a ragged tail an epoch, 2 epochs across the learning-rate
             drop) under ``pallas_fused`` and ``pallas_bf16``:
             ``fit(mesh=make_mesh(), epoch_scan=True)``, a world of one
             over NCCL, must write the single-device graph fit's log and
             checkpoints and end in its state, bit for bit (the
             single-device batches given the all-ones ``weight`` that
             ``shard_batch`` appends), its loss kernels' launches counted
             as the scan phase counts them (``dpscan_launches``); two
             epochs of ``make_epoch_scan(mesh=...)`` with the step's
             collectives forced on at a world of one (the checks of
             ``all_sum`` and ``dp._sum_over_ranks`` handed a crossing
             mesh): the all-reduces recorded into the graph counted on
             the host, NCCL's kernels in a traced replayed epoch against
             an eager step's times the replays, the losses and state the
             unforced epochs' bits, and the unweighted single-device
             epochs' distance from them; two gloo ranks on the card
             refused before any step; ms a graph step of the
             single-device graph, of it on the weighted batches, of the
             mesh graph and of the forced-collective one by CUDA events,
             in turns;
14. zero   — ZeRO-1 and FSDP (``svs_torch.parallel.zero``) beside DP, cuDNN
             deterministic: a world of one over NCCL, the full-width
             ``default`` step at B = 32 under ``pallas_fused`` and
             ``pallas_bf16`` (counts zeroed just before each step and read
             just after; each sharded step must be ``make_train_step``'s
             bits, Adam's moments included), then two ranks on the card
             over dp's backend, float32, 2 x 16: each sharded step the DP
             two-rank step's bits, each rank's resting state within 1 % of
             117.9 / 78.6 / 58.9 MB (DP / ZeRO-1 / FSDP), its peak memory
             and the steps' ms (CUDA events, in turns) printed beside, no
             program built over gloo; at the world of one each sharded
             layout's train and eval programs against their eager bodies
             under the three loss paths and a programmed ``fit`` of
             each, as the dp phase's;
15. tp     — tensor parallelism (``svs_torch.parallel.tp``) beside DP, cuDNN
             deterministic: a (1, 1) mesh over NCCL, the full-width
             ``default`` step at B = 32 under ``pallas_fused`` and
             ``pallas_bf16`` (counts zeroed just before each step and read
             just after; the TP step must be ``make_train_step``'s bits),
             then the (1, 2) and (2, 2) meshes of ranks on the card over
             dp's backend, float32: the TP step within the dry run's
             envelope of the single-process B = 32 step, the ranks'
             gathered states the same bits, enc4's kernel cut to 64 of its
             128 output channels, each rank's resting state within 1 % of
             58,946,172 bytes (FSDP's over two ranks), its peak memory and
             the steps' ms (CUDA events, in turns) printed beside DP's,
             no program built over gloo; at (1, 1) the TP train and eval
             programs against their eager bodies under the three loss
             paths and a programmed ``fit``, as the dp phase's;
16. pp     — pipeline parallelism (``svs_torch.parallel.pp``) with both
             stages on ``cuda:0``, the ``default`` preset, B = 32, split 3,
             cuDNN deterministic: the one-microbatch PP step under
             ``pallas_fused`` and ``pallas_bf16`` (counts zeroed just before
             each PP step and read just after) must be ``make_train_step``'s
             bits on the same batch and generator; four microbatches
             (float32, ``pallas_fused``) and a batch padded from 24 rows
             whose last microbatch is empty (float32, ``pallas_bf16``)
             against the port's microbatch-loop oracle
             (``dryrun.microbatch_oracle``: the loss and the BN running
             statistics its bits, the step within the dry run's envelope);
             each step a program (``pp.programmed``: both stages one
             card; the eager step over two distinct devices) whose three
             calls give its eager body's bits (the generator's state
             too) and, at one microbatch, ``make_train_step``'s program's;
             the one-microbatch programs under the three loss paths
             against their eager bodies over fit's batches padded to
             B = 32 (``layout_programs``, eval programs too), the
             four-microbatch program over full and ragged batches with
             dropout on; the single program's, the PP programs' and the
             PP eager steps' ms by CUDA events in turns, a traced
             replay's loss-kernel launches (once a live microbatch), the
             programs' bytes, each stage's resting bytes and the card's
             peak memory over each step; one epoch of
             ``fit(parallel="pp")`` whose ``.ckpt`` the single-device
             ``fit`` resumes, and two programmed epochs against the eager
             ones, bit for bit;
17. cp     — context parallelism (``svs_torch.parallel.halo``): a world of
             one over NCCL, cuDNN deterministic, the ``fine_tune`` preset
             at full width (bf16, remat), B = 4 patches of 1536 frames: the
             CP step (the halo arithmetic as a zero pad and valid convs)
             under ``pallas_fused`` and ``pallas_bf16`` (counts zeroed just
             before each step and read just after) within the dry run's
             envelope of ``make_train_step`` on the same batch and
             generator, whether the bits agree printed, the programs'
             replay ms in turns; the CP train program against its eager
             body at that shape under the three loss paths
             (``layout_programs``: B = 4 patches, a batch whose last row
             weighs 0, a tail of 2; its validation is the single eval
             program's on the whole batch); the whole-song CP decode
             (float32, ``default`` preset) of a 3072-frame song, which both decodes pad alike,
             within 3e-5 of ``separate_magnitude(mode="whole")``, and of a
             240-s song (2560 frames, which the unsharded decode pads to
             3072) within 3e-5 of the unsharded forward at CP's padding,
             each decode's ms by CUDA events and the card's peak memory
             beside the unsharded decode's, the time-sharded mask a
             program (its eager body's bits, both timed); one
             epoch of ``fit(parallel="cp")`` (the dataset on the card,
             time-sharded) whose ``.ckpt`` the single-device ``fit``
             resumes, and two programmed epochs against the eager ones;
             then one pool of 4 ranks on the card over dp's
             backend, float32: on its first 2 (``pallas_fused``) and on
             all 4 (``pallas_bf16``) the CP step within the envelope, the
             ranks' states the same bits, and on 2 ranks both decodes
             (their mask eager by the rule over gloo);
             ``train_cli --cp --dp`` exits 2;
18. mh     — multi-host training (``svs_torch.parallel.multihost``) in one
             pool of two hosts of one rank each on the card, over gloo
             (NCCL refuses two ranks on one card), cuDNN deterministic:
             the float32 ``default`` DP step of B = 32, 16 rows a host,
             under ``pallas_fused`` and ``pallas_bf16`` (the loss kernels'
             counts zeroed just before each step and read just after, on
             rank 0: ``mh_launches``) within the dry run's envelope of
             ``make_train_step`` on the host-major 32-row batch, the ranks
             the same bits; ``MultiHostDeviceDataset`` blocks against
             ``global_batch_from_local`` of the host pipeline, bit for bit,
             on the 3 songs (2 and 1 a host) with the epoch's ragged tail
             and with wrapped full batches; ``Augmenter.apply_sharded`` on
             the card against the numpy oracle (the ranks viewed as one
             host's two shards, the second half padded); one epoch of
             two-host ``fit`` at the full ``default`` preset, B = 32, under
             ``pallas_fused``, with the songs on the card and on the host
             (the same steps on both hosts and the same bits between the
             feeds; rank 0 alone writes), and a resume where host 1 has no
             checkpoint (``sync_resume``: the ranks the same bits after);
             one ``mh:`` JSON line with the phase's seconds and each rank's
             peak memory over the steps;
19. parity — the U-Net at float32 on the card (cuDNN, TF32 off) against the
             same weights and input on the CPU, and one float32 ``fft``
             train step (B = 4, no dropout) on the card against the CPU.

Each phase's seconds are printed on a ``phase seconds`` line.

The line before the last is the ``nvidia-smi`` name and power limit, the one
before it the ``kernels`` JSON; the last line is the ``{"ok": true, ...}``
JSON.  Any failed check raises, so the exit code is not 0 and no result line
is printed.  Without a CUDA device, or without the repository beside it, the
script fails the same way.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32
# outside the tensor cores, bf16 on the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SR = 8192
SONG_SECONDS = 60
N_SONGS = 3
# bench_cli --frontend's default signal length (seconds, not bucketed)
FRONTEND_SECONDS = 240
# kernel tolerance: tests/test_pallas.py's bound for the TPU kernel against
# the exact FFT; both sides here are f32 sums in different orders
ATOL, RTOL = 2e-3, 1e-4
# the front end's mixed-route case whose times the kernels line carries
MIXED_LABEL = "4-min song, n_fft 1000 (mixed route)"
# float32 U-Net, cuDNN (TF32 off) against oneDNN on the CPU: the same sums
# in other orders through 12 conv layers; the sigmoid's slope is <= 1/4
UNET_F32_ATOL = 1e-4
# bf16 U-Net, cuDNN against the CPU: both round every activation to bf16
# (2^-8 relative), so a sum taken in another order can round one ulp apart
# and carry through the layers; tests/test_torch_unet.py's bf16 bound
UNET_BF16_MAX, UNET_BF16_MEDIAN = 1e-2, 1e-3
# the MR-STFT loss kernels against their plain versions: the same bf16
# products, f32 sums in other orders (tensor-core accumulators against
# cuBLAS's f32 GEMM); the backward rounds the scaled re/im cotangents to
# bf16 on both sides, where one f32 ulp of difference moves a value by a
# bf16 ulp (tests/test_torch_cuda.py's and tests/test_fused_loss.py's bounds)
MAG_ATOL, MAG_RTOL = 2e-3, 1e-3
PARTIALS_RTOL = 1e-4
GRAD_MAX, GRAD_COS = 2e-2, 0.9999
# the train step's loss resolutions and shapes (default preset, B = 32
# patches of 128 frames -> 768 * 127 samples)
RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
TRAIN_B, TRAIN_T = 32, 768 * 127
IMPLS = ("matmul_bf16", "pallas_fused", "pallas_fused_wide", "pallas_bf16")
# matmul_bf16 with its route to the loss kernels refused: the PyTorch
# composition, which runs no loss kernel, the baseline of the cross-checks
# below (``_route_to_kernels``)
COMPOSITION = "composition"
# first-step MR-STFT loss of each implementation that runs a loss kernel
# against the composition's, same card, weights, batch and dropout masks:
# tests/test_fused_loss.py:95's bound between these paths
MR_RTOL = 5e-3
# first-step grad_norm of each kernel implementation against the
# composition's:
# the loss kernels' backward rounds the scaled re/im cotangents to bf16 at
# other points than the bf16 matmul path, a 2^-8 relative change per
# element with no common sign over ~10^7 elements, so the norm of the
# U-Net's gradient moves far less (8.5e-6 relative observed on the H100);
# 1e-3 leaves two orders of room and still catches a wrong adjoint
GN_RTOL = 1e-3
# float32 train step, card (cuDNN and cuFFT, TF32 off) against the CPU:
# __graft_entry__.py's envelope for one step against another
# implementation of it, except the loss, whose 3 FFT resolutions and 12
# convs sum in other orders on the two backends (1e-4 relative)
STEP_LOSS_RTOL, STEP_GN_RTOL, STEP_BN_ATOL = 1e-4, 1e-3, 1e-4
# the DP step's kernel paths and their loss-kernel launches a step
# (spectral_mag fwd, bwd, loss_partials fwd, bwd)
DP_PER_STEP = {"pallas_fused": (0, 0, 3, 3), "pallas_bf16": (6, 3, 0, 0)}
# the SP decode's song (seconds at 8192 Hz) and its bound against the
# unsharded decode: tests/test_infer_mesh.py's, float32 on both sides
SP_SECONDS, SP_ATOL = 240, 2e-5
# the state a rank holds between steps at the default preset's full width
# over two ranks (9,823,313 float32 parameters and Adam's two moments,
# counted from their shapes), MB of 1e6 bytes, and the bound on a reading
ZERO_MB = {"dp": 117.9, "zero1": 78.6, "fsdp": 58.9}
ZERO_MB_RTOL = 0.01
# the meshes of the tp phase's ranks on the one card, and the state a rank
# holds between their steps: over two model ranks the channel rule cuts
# the same leaves as FSDP over two ranks (the zero phase's reading), bytes
TP_MESHES = ((1, 2), (2, 2))
TP_BYTES = 58_946_172
# the pp phase's split and microbatches (train_cli's --pp defaults), the
# real rows of its ragged batch, and its timing reps
PP_SPLIT, PP_MICRO, PP_REAL_ROWS, PP_REPS = 3, 4, 24, 5
# the cp phase: B patches of the fine_tune preset's 1536 frames, the ranks
# on the one card, and the whole-song decode's song at the default preset:
# 4 minutes (2560 frames) rounded up to the unsharded decode's bucket of
# 1024 frames (8 x input_len), so that both decodes pad it alike (CP pads
# to 64 frames a rank; the 240-s song itself is held against the unsharded
# forward at CP's padding); its bound is tests/test_infer_mesh.py's,
# float32
CP_B, CP_REPS = 4, 3
# the ranks on the card, in one pool (its first 2, then all 4: a pool's
# start on the card costs more than its steps), and the loss path each
# world steps under
CP_RANKS = ((2, "pallas_fused"), (4, "pallas_bf16"))
CP_FRAMES, CP_ATOL = 3072, 3e-5
# the mh phase: its hosts (of one rank each, on the one card), the local
# batch and patches a song of its data check (the 3 songs split 2 and 1:
# 6 and 3 patches, batches of 4 with a ragged tail on each host), the
# rows and real rows of its remix check, and the remix's bound against
# the float64 numpy oracle (magnitudes relative to the largest, angles in
# radians modulo 2 pi): svs_tpu's rtol against its oracle
# the clocks phase: the seed and number of the eager launches held against
# the plain version, the replays of the captured graph, its two pieces of
# work (float32 matmuls of 2048 in a chain), the marks of the cost's graph
# and the spans of the host's cost
CLOCK_SEED, CLOCK_LAUNCHES, CLOCK_REPLAYS = 25, 200, 50
CLOCK_WORK, CLOCK_MARKS, CLOCK_SPANS = (4, 8), 1000, 100_000
MH_HOSTS, MH_LOCAL_BS, MH_SAMPLES = 2, 4, 3
MH_AUG_ROWS, MH_AUG_REAL, MH_AUG_TOL = 8, 6, 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


_TAKE = []  # mrstft's own rule, kept while a phase refuses the route


def _route_to_kernels(allowed: bool) -> None:
    """Let ``matmul_bf16`` take the loss kernels' rounded instances on the
    card (the program's rule, ``mrstft._kernels_take``) or refuse it, so
    that it runs the PyTorch composition (``COMPOSITION``)."""
    from svs_torch.losses import mrstft
    if not _TAKE:
        _TAKE.append(mrstft._kernels_take)
    mrstft._kernels_take = _TAKE[0] if allowed else (lambda *args: False)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def write_songs(np, wav, root: str, seed: int) -> None:
    """MUSDB-layout folder: <root>/songN/{mixture,vocals}.wav."""
    rng = np.random.default_rng(seed)
    t = np.arange(SONG_SECONDS * SR) / SR
    for i in range(N_SONGS):
        d = os.path.join(root, f"song{i}")
        os.makedirs(d)
        f0 = rng.uniform(150, 600)
        vocal = 0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.01 * np.sin(t)))
        accomp = 0.2 * rng.standard_normal(len(t))
        wav.write_wav(os.path.join(d, "mixture.wav"),
                      (vocal + accomp).astype(np.float32), SR)
        wav.write_wav(os.path.join(d, "vocals.wav"),
                      vocal.astype(np.float32), SR)


def device_events(torch, fn, reps: int = 1, cpu: bool = False):
    """The kernels that ``reps`` calls of ``fn`` launched, as (name, device
    ms, launches), from a torch.profiler trace (``cpu``: the host's
    activity traced too).  A trace without device time is taken again, up
    to three times: on the H100 one trace of work that ran held no kernel
    records (once in PR 5's runs), and a measurement, not the kernel, was
    at fault."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    for _ in range(3):
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        if sum(ms for _, ms, _ in events) > 0:
            return events
    check(False, "the profiler saw the calls' device time")


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call: the summed duration of the kernels
    it launched, from a torch.profiler trace of ``reps`` calls.  Unlike
    :func:`cuda_ms` it leaves out the gaps while the host enqueues, which a
    kernel of ~20 us a call does not cover."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return sum(ms for _, ms, _ in device_events(torch, fn, reps)) / reps


def spec_kernel_ms(torch, fn, reps: int = 10, warmup: int = 3):
    """Device time of one ``fn()`` call summed over the hand-written loss
    kernels it launched (names in namespace ``spec::``), and that time by
    kernel, from a torch.profiler trace of ``reps`` calls; the padding,
    casts and fold around them are left out.

    The mean is taken over the launches the trace holds, not over
    ``reps``, and a trace that holds fewer is reported: on the H100 two
    traces of 10 calls read a kernel 1.5x faster than the six others of
    the same code while the CUDA events of the same calls did not move,
    as a trace missing about a third of its records would.  A trace that
    holds device time but no ``spec::`` record is taken again, up to three
    times, as :func:`device_events` retakes one without device time: on
    the H100 one trace of a ``loss_partials`` call that ran held only the
    kernels around it (once in a full run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        by = {}
        for key, ms, count in device_events(torch, fn, reps):
            if "spec::" in key:
                name = key.split("(")[0].replace("void ", "")
                per_call = max(1, round(count / reps))  # launches a call
                if count != per_call * reps:
                    print(f"profiler: {count} records of {name} for {reps} "
                          f"calls; the mean is taken over the {count}")
                by[name] = by.get(name, 0.0) + ms / count * per_call
        if sum(by.values()) > 0:
            break
        print("profiler: a trace held no loss-kernel record; taken again")
    check(sum(by.values()) > 0, "the profiler saw the loss kernels")
    return sum(by.values()), by


def loss_inputs(torch, np, n_fft: int):
    """The train step's shapes at one resolution, seeded by it: x, y
    (B, T), a magnitude cotangent and a partials cotangent."""
    rng = np.random.default_rng(n_fft)
    x, y = (torch.from_numpy((rng.standard_normal((TRAIN_B, TRAIN_T)) * 0.3)
                             .astype(np.float32)).cuda() for _ in range(2))
    n_frames = 1 + TRAIN_T // dict((r[0], r[1]) for r in RESOLUTIONS)[n_fft]
    g_mag = torch.from_numpy(rng.standard_normal(
        (TRAIN_B, n_fft // 2 + 1, n_frames)).astype(np.float32)).cuda()
    g_part = torch.from_numpy(rng.uniform(0.5, 1.5, (TRAIN_B, 3)).astype(
        np.float32)).cuda()
    return x, y, g_mag, g_part


def loss_times(torch, np, cdm, cfl) -> dict:
    """Device time (``spec_kernel_ms``) and CUDA-event time of the four
    loss kernels at each train resolution, through the wrappers of the
    ``diff_mag`` and ``fused_loss`` modules given (this tree's or an
    earlier one's), and of loss_partials' rounded instances where the tree
    has them."""
    import inspect
    rounded = "rounded" in inspect.signature(cfl.loss_partials_fwd).parameters
    out = {}
    for n_fft, hop, win in RESOLUTIONS:
        geo = (n_fft, hop, win)
        x, y, g_mag, g_part = loss_inputs(torch, np, n_fft)
        calls = {
            "spectral_mag_fwd": lambda: cdm.spectral_mag_fwd(x, *geo),
            "spectral_mag_bwd": lambda: cdm.spectral_mag_bwd(x, g_mag, *geo),
            "loss_partials_fwd": lambda: cfl.loss_partials_fwd(x, y, *geo),
            "loss_partials_bwd": lambda: cfl.loss_partials_bwd(x, y, g_part,
                                                               *geo),
        }
        if rounded:
            calls["loss_partials_fwd_rounded"] = lambda: cfl.loss_partials_fwd(
                x, y, *geo, rounded=True)
            calls["loss_partials_bwd_rounded"] = lambda: cfl.loss_partials_bwd(
                x, y, g_part, *geo, rounded=True)
        for name, fn in calls.items():
            ms, by = spec_kernel_ms(torch, fn)
            out.setdefault(name, {})[f"{n_fft}/{hop}/{win}"] = {
                "ms": ms, "by_kernel": by,
                "event_ms": cuda_ms(torch, fn, reps=10)}
    for name, shapes in out.items():
        shapes["sum"] = {k: sum(t[k] for t in shapes.values())
                         for k in ("ms", "event_ms")}
    return out


def mixed_ops(cdsp, n_fft: int, n_frames: int, per_bin: int) -> float:
    """Real operations of the mixed kernel's plan over ``n_frames`` frames:
    the window multiply, each pass's butterflies and twiddles (and for
    Bluestein the chirp, both L-point transforms, the filter and the
    post-chirp), the split step and the epilogue."""
    plan = cdsp.mixed_plan(n_fft)

    def butterfly(r: int) -> int:
        if r % 2:   # dft_odd: sums, differences, 2 FMAs a term of each sum
            h = (r - 1) // 2
            return 8 * h * h + 10 * h
        return {2: 4, 4: 16, 8: 56}[r]

    passes = sum(plan.q // r * (butterfly(r) + 6 * (r - 1))
                 for r, _ in plan.passes)
    if plan.bluestein:
        # chirp, forward and inverse transforms, filter, post-chirp
        passes = 2 * passes + 6 * plan.q + 12 * plan.p
    n_seq = -(-n_frames // plan.frames_per_seq)
    n_bins = n_fft // 2 + 1
    split = 8 if n_fft % 2 else 16
    return n_seq * passes + n_frames * (n_fft + (split + per_bin) * n_bins)


def frontend_phase(torch, np, cdsp, phase: bool):
    """The front-end kernels against their plain versions: ``stft_magphase``
    (``phase``) or ``stft_magnitude``, on the fft route (power-of-two n_fft
    in [64, 4096]) and the mixed route (n_fft 1000, 1536, 441, 999, 1018,
    8192: 7-smooth, odd and Bluestein plans), with the gemm kernel (the
    earlier design) timed beside each even n_fft at the same shape; returns
    the JSON entry."""
    rng = np.random.default_rng(0)

    def signal(n_samples: int, bucket: int = 1 << 18):
        n = -(-n_samples // bucket) * bucket  # prep's 2^18-sample bucket
        y = np.zeros(n, np.float32)
        y[:n_samples] = rng.standard_normal(n_samples) * 0.3
        return torch.from_numpy(y).cuda()

    song = signal(4 * 60 * SR)
    cases = [
        # (label, signal, n_fft, hop)
        ("decode 4-min song, default", song, 1024, 768),
        ("main-path 60-s song, default", signal(SONG_SECONDS * SR), 1024, 768),
        ("hq44k 60-s song, hop 256 (K=4)", signal(60 * 44100), 1024, 256),
        ("4-min song, n_fft 2048", song, 2048, 512),
        ("4-min song, n_fft 4096", song, 4096, 1024),
        (MIXED_LABEL, song, 1000, 250),
        ("4-min song, n_fft 1536 (mixed route)", song, 1536, 384),
        ("4-min song, n_fft 441 (mixed route, odd)", song, 441, 110),
        ("4-min song, n_fft 999 (mixed route, odd, Bluestein)", song, 999,
         256),
        ("4-min song, n_fft 1018 (mixed route, Bluestein)", song, 1018, 256),
        ("4-min song, n_fft 8192 (mixed route)", song, 8192, 2048),
        ("zero signal", torch.zeros(1 << 18, device="cuda"), 1024, 768),
        ("zero signal, n_fft 1000", torch.zeros(1 << 18, device="cuda"),
         1000, 250),
        ("zero signal, n_fft 999", torch.zeros(1 << 18, device="cuda"),
         999, 256),
    ]
    if phase:
        name, main_label = "stft_magphase", "decode 4-min song, default"
        kernel = cdsp.stft_magphase
    else:
        # bench_cli --frontend's own signal: 240 s, not bucketed
        name, main_label = "stft_magnitude", "bench --frontend 240-s song"
        kernel = cdsp.stft_magnitude
        cases.append((main_label, signal(FRONTEND_SECONDS * SR, bucket=1),
                      1024, 768))
    routes = ("fft", "mixed", "gemm")
    max_err = 0.0
    timing = {}
    for label, y, n_fft, hop in cases:
        via = cdsp.route(n_fft)
        plain = cdsp.plain_for(n_fft, phase)
        before = [getattr(cdsp, f"{r}_launches") for r in routes]
        got = kernel(y, n_fft, hop)
        torch.cuda.synchronize()
        moved = [getattr(cdsp, f"{r}_launches") - c
                 for r, c in zip(routes, before)]
        check(moved == [int(r == via) for r in routes],
              f"{name} {label}: one launch on the {via} route")
        want = plain(y, n_fft, hop)
        if phase:
            (mag, ph), (ref_mag, ref_ph) = got, want
            spec, ref_spec = mag * ph, ref_mag * ref_ph
            e_spec = (spec - ref_spec).abs().max().item()
            check(torch.equal(mag, cdsp.stft_magnitude(y, n_fft, hop)),
                  f"{label}: stft_magnitude's magnitude is stft_magphase's, "
                  "bit for bit")
        else:
            mag, ref_mag = got, want
        e_mag = (mag - ref_mag).abs().max().item()
        scale = max(ref_mag.abs().max().item(), 1e-30)
        line = (f"kernel {name} {label}: route={via} samples={y.numel()} "
                f"frames={mag.shape[1]} max_abs_err mag={e_mag:.3e} ")
        if phase:
            line += f"mag*phase={e_spec:.3e} "
        line += f"max_rel_err mag={e_mag / scale:.3e}"
        print(line + (f" mag*phase={e_spec / scale:.3e}" if phase else ""))
        torch.testing.assert_close(mag, ref_mag, atol=ATOL, rtol=RTOL)
        max_err = max(max_err, e_mag)
        if phase:
            torch.testing.assert_close(spec, ref_spec, atol=ATOL, rtol=0)
            max_err = max(max_err, e_spec)
        if label.startswith("zero signal"):
            check(bool((mag == 0).all()), f"{name} {label}: mag is 0")
            if phase:
                check(bool((ph[0] == 1).all() and (ph[1] == 0).all()),
                      f"{label}: phase is exactly 1+0j")
            continue
        window = torch.hann_window(n_fft, device="cuda")
        runs = {
            "ms": lambda: kernel(y, n_fft, hop),
            "plain_ms": lambda: plain(y, n_fft, hop),
            "library_ms": lambda: torch.stft(
                y, n_fft, hop, window=window, center=True,
                pad_mode="constant", return_complex=True).abs(),
        }
        if n_fft % 2 == 0:
            # the gemm design at the same shape, through its C entry
            runs["earlier_ms"] = lambda: cdsp.launch(y, n_fft, hop, phase,
                                                     "gemm")
        # the plain versions launch hundreds of small kernels a call, whose
        # traces take seconds to read: 5 calls of them
        t = {k: device_ms(torch, fn, **({"reps": 5, "warmup": 1}
                                         if k == "plain_ms" else {}))
             for k, fn in runs.items()}
        # the same calls back to back by CUDA events: for a kernel of tens
        # of microseconds this reads the host's enqueue, not the card
        t["event_ms"] = cuda_ms(torch, runs["ms"])
        t["library_event_ms"] = cuda_ms(torch, runs["library_ms"])
        n_bins, n_frames = mag.shape
        # the least work of the function: per frame the window multiply, a
        # real FFT (2.5 n log2 n operations, half a complex FFT's 5 n log2 n)
        # and, per bin, |z| (3) and the two divides of the unit phase (3
        # more); the signal read once, magnitude (and phase) written once
        planes, per_bin = (3, 6) if phase else (1, 3)
        flops = n_frames * (n_fft + 2.5 * n_fft * math.log2(n_fft)
                            + per_bin * n_bins)
        bytes_ = 4 * (y.numel() + planes * n_bins * n_frames)
        t["bound_ms"] = max(flops / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES) * 1e3
        t["bound_by"] = ("operations" if flops / PEAK_F32_FLOPS
                         >= bytes_ / PEAK_BYTES else "bytes")
        t["gflop"] = flops / 1e9
        t["mbytes"] = bytes_ / 1e6
        if via == "fft":
            # the kernel's own work: per frame the window multiply, the
            # n/2-point complex FFT (5 (n/2) log2(n/2)), the split step
            # (16 a bin) and the epilogue, over the f32 peak, or its bytes
            m = n_fft // 2
            form = n_frames * (n_fft + 5 * m * math.log2(m) + 16 * (m - 1)
                               + per_bin * n_bins)
        else:
            # the mixed kernel's plan: its passes' real operations (both
            # L-point transforms for Bluestein), the pack and the split
            form = mixed_ops(cdsp, n_fft, n_frames, per_bin)
        t["formulation_bound_ms"] = max(form / PEAK_F32_FLOPS,
                                        bytes_ / PEAK_BYTES) * 1e3
        t["formulation_gflop"] = form / 1e9
        print(f"kernel {name} {label} times: " + json.dumps(t))
        timing[label] = dict(t, samples=y.numel(), n_fft=n_fft, hop=hop,
                             route=via)
    main = timing[main_label]
    for label, t in timing.items():
        if "earlier_ms" in t and (t["route"] == "mixed" or t["n_fft"] == 1024):
            print(f"kernel {name} {label}: {t['route']} {t['ms']:.5f} ms, "
                  f"gemm {t['earlier_ms']:.5f} ms "
                  f"({t['earlier_ms'] / t['ms']:.2f}x), torch.stft + abs "
                  f"{t['library_ms']:.5f} ms "
                  f"({t['library_ms'] / t['ms']:.2f}x), bound "
                  f"{t['bound_ms']:.5f} ms ({t['ms'] / t['bound_ms']:.2f}x)")
    mixed = timing[MIXED_LABEL]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "earlier_ms", "formulation_bound_ms", "event_ms")
    return {
        "name": name,
        "route": "cuda",
        "source": "svs_torch/csrc/stft_fft.cu",
        "sources": {"fft": "svs_torch/csrc/stft_fft.cu",
                    "mixed": "svs_torch/csrc/stft_mixed.cu",
                    "gemm": "svs_torch/csrc/stft_magphase.cu"},
        "replaces": ("svs_tpu/ops/pallas/dsp.py:179" if phase
                     else "svs_tpu/ops/pallas/dsp.py:115"),
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "torch.stft (cuFFT) + abs",
        "earlier_ms": main["earlier_ms"],
        "earlier": ("the gemm design (svs_torch/csrc/stft_magphase.cu, now "
                    "the route of an even n_fft above 16384), same shape, "
                    "same run"),
        "formulation_bound_ms": main["formulation_bound_ms"],
        "timing": ("device time per call, torch.profiler, 20 calls (the "
                   "plain version 5)"),
        "shape": {"samples": main["samples"], "n_fft": 1024, "hop": 768},
        # the mixed route (every other n_fft up to 16384) at n_fft 1000
        "mixed": dict({k: mixed[k] for k in keys},
                      shape={"samples": mixed["samples"], "n_fft": 1000,
                             "hop": 250}),
        "other_shapes": {k: v for k, v in timing.items() if k != main_label},
    }


def phase_clock_phase(torch, np) -> dict:
    """Phase 2b (the module's docstring): the phase clock kernel against
    its plain version, then its phases against CUDA events, and its cost."""
    from svs_torch.utils import profiling

    dev = torch.device("cuda", 0)
    launch = profiling._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    size = 1 + 2 * profiling.PHASE_SLOTS

    # the arithmetic: the kernel's buffer after each launch against the
    # plain version's, given the stamp that launch wrote
    buf = torch.zeros(size, dtype=torch.int64, device=dev)
    plain = np.zeros(size, np.int64)
    rng = np.random.default_rng(CLOCK_SEED)
    slots = [-1] + [int(k) for k in rng.integers(
        -1, profiling.PHASE_SLOTS, CLOCK_LAUNCHES)]
    for slot in slots:
        check(launch(buf.data_ptr(), slot, stream) == 0,
              f"the phase clock kernel launched (slot {slot})")
        got = buf.cpu().numpy()  # waits for the launch
        check(got[0] >= plain[0], "the clock's stamps never go back")
        profiling._clock_plain(plain, slot, int(got[0]))
        check(np.array_equal(got, plain),
              f"the clock kernel's buffer is _clock_plain's after slot "
              f"{slot}")
    check(plain[2::2].sum() == sum(k >= 0 for k in slots),
          "every launch of a slot counted once")

    # the phases of a captured graph against CUDA events
    a = torch.randn(2048, 2048, device=dev) / math.sqrt(2048)
    x = torch.randn(2048, 2048, device=dev)

    def work(n):
        y = x
        for _ in range(n):
            y = a @ y
        return y

    def body():
        profiling.mark(profiling.BEGIN, dev)
        work(CLOCK_WORK[0])
        profiling.mark("smoke.short", dev)
        work(CLOCK_WORK[1])
        profiling.mark("smoke.long", dev)

    body()  # the first marks: eager, so the buffer is made outside a capture
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    eager_ms = [cuda_ms(torch, lambda n=n: work(n), reps=CLOCK_REPLAYS)
                for n in CLOCK_WORK]
    profiling.reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(CLOCK_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    timed_ms = start.elapsed_time(end) / CLOCK_REPLAYS
    eager_ms = [(e + cuda_ms(torch, lambda n=n: work(n), reps=CLOCK_REPLAYS))
                / 2 for e, n in zip(eager_ms, CLOCK_WORK)]
    phases = profiling.snapshot()["phases"]["cuda"]
    names = ("smoke.short", "smoke.long")
    check({n: phases[n]["count"] for n in names}
          == dict.fromkeys(names, CLOCK_REPLAYS),
          f"each phase counted once a replay: {phases}")
    clocked_ms = [1e3 * phases[n]["s"] / CLOCK_REPLAYS for n in names]
    check(abs(sum(clocked_ms) - timed_ms) <= 0.01 * timed_ms,
          f"the phases' sum {clocked_ms} ms against the replay's "
          f"{timed_ms:.4f} ms by CUDA events")
    for n, got, want in zip(names, clocked_ms, eager_ms):
        check(abs(got - want) <= 0.03 * want,
              f"phase {n}: {got:.4f} ms against its work's {want:.4f} ms "
              "by CUDA events")

    # the cost: a mark in a replay, a span on the host with no profiler
    marks = torch.cuda.CUDAGraph()
    with torch.cuda.graph(marks):
        for _ in range(CLOCK_MARKS):
            profiling.mark("smoke.mark", dev)
    mark_us = 1e3 * cuda_ms(torch, marks.replay, reps=10) / CLOCK_MARKS
    span_ns = {}
    for label, always in (("plain", False), ("always", True)):
        t0 = time.perf_counter_ns()
        for _ in range(CLOCK_SPANS):
            with profiling.annotate("smoke.span", always=always):
                pass
        span_ns[label] = (time.perf_counter_ns() - t0) / CLOCK_SPANS
    profiling.reset()
    line = {"launches": len(slots), "replays": CLOCK_REPLAYS,
            "phase_ms": dict(zip(names, clocked_ms)),
            "events_ms": dict(zip(names, eager_ms)),
            "replay_events_ms": timed_ms, "mark_us": mark_us,
            "span_ns_no_profiler": span_ns}
    print("clocks: " + json.dumps(line))
    return line


def build_phase(build, names, reported) -> None:
    """Build every kernel library at once, one nvcc each; print seconds,
    then what ptxas says of the kernels of the libraries ``reported``
    (registers, shared memory, spills), both reports built together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    build.load_all(names)
    print(f"build {', '.join(names)} (one nvcc each, all started "
          f"together): {time.perf_counter() - t0:.1f} s")
    with ThreadPoolExecutor(len(reported)) as pool:
        reports = list(pool.map(build.ptxas_report, reported))
    for name, report in zip(reported, reports):
        for line in report.splitlines():
            if any(k in line for k in ("Compiling entry", "spill", "Used",
                                       "Performance")):
                print(f"ptxas {name}.cu: {line.strip()}")


def _rel_err(got, want):
    d = (got - want).abs().max().item()
    return d, d / max(want.abs().max().item(), 1e-30)


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return ((a @ b) / (a.norm() * b.norm())).item()


def _fft_ops(n_fft: int, win: int) -> float:
    """Operations of one frame's real FFT and its window multiply."""
    return win + 2.5 * n_fft * math.log2(n_fft)


def loss_bounds(name: str, geo):
    """(bound_ms, bound_by, formulation_bound_ms) of one call at the
    ``spectral.Geometry`` geo.

    bound: the function's least work, the larger of its bytes (inputs read
    once, outputs written once) over HBM and its operations (real FFTs of
    the frames, inverse FFTs in a backward, and the per-cell arithmetic)
    over the f32 peak.  formulation: the kernels' own GEMMs on the bf16
    tensor cores, a multiply and an add per term, or the bytes, whichever
    is larger: the window-deep DFT of each signal over the taps the kernels
    contract (``n_taps``, whole 64-tap stages, the same in both
    directions), and in a backward its adjoint, hop-wide rows times the
    shifts that meet the window."""
    b, t, n_fft, win = geo.batch, geo.t, geo.n_fft, geo.win
    n_bins = n_fft // 2 + 1
    frames, cells = b * geo.n_frames, b * geo.n_frames * n_bins
    fft = frames * _fft_ops(n_fft, win)
    dft = 2.0 * frames * n_fft * geo.n_taps           # one signal's DFT
    adjoint = (2.0 * b * geo.rows * geo.hop_width * geo.hop_tiles * n_fft
               * geo.n_shifts)
    sig, mag = 4 * b * t, 4 * cells
    flops, bytes_, gemm = {
        "spectral_mag_fwd": (fft + 4 * cells, sig + mag, dft),
        "spectral_mag_bwd": (2 * fft + 8 * cells, 2 * sig + mag,
                             dft + adjoint),
        "loss_partials_fwd": (2 * fft + 14 * cells, 2 * sig + 12 * b,
                              2 * dft),
        "loss_partials_bwd": (3 * fft + 20 * cells, 3 * sig + 12 * b,
                              2 * dft + adjoint),
    }[name]
    f_ms, b_ms = flops / PEAK_F32_FLOPS * 1e3, bytes_ / PEAK_BYTES * 1e3
    form_ms = max(gemm / PEAK_BF16_FLOPS * 1e3, b_ms)
    return (max(f_ms, b_ms), "operations" if f_ms >= b_ms else "bytes",
            form_ms)


# geometries past the loss kernels' old limits, which the Pallas kernels
# always took: (B, T, n_fft, hop, win, what it exercises)
WIDENED = (
    (TRAIN_B, TRAIN_T, 64, 16, 64, "n_fft % 128: DDSP's smallest scale"),
    (TRAIN_B, TRAIN_T, 1000, 125, 600, "odd hop, n_fft % 128"),
    (TRAIN_B, TRAIN_T, 129, 33, 100, "odd n_fft (no Nyquist), odd hop"),
    (TRAIN_B, TRAIN_T, 1024, 700, 1024, "loss_partials' spans in pieces"),
    (TRAIN_B, TRAIN_T, 2048, 1298, 1200, "both kernels' spans in pieces"),
    (4, 4_000, 2048, 2, 1200, "600 adjoint shifts in groups"),
)


def widened_phase(torch, np, cdm, cfl, sp) -> dict:
    """The four loss kernels at each geometry of ``WIDENED`` against their
    plain versions, within the train shapes' tolerances, timed by CUDA
    events; returns {kernel name: {geometry: numbers}}."""
    rng = np.random.default_rng(4)
    out = {}
    for b, t, n_fft, hop, win, what in WIDENED:
        geo = (n_fft, hop, win)
        g = sp.Geometry(b, t, *geo)
        x, y = (torch.from_numpy((rng.standard_normal((b, t)) * 0.3).astype(
            np.float32)).cuda() for _ in range(2))
        g_mag = torch.from_numpy(rng.standard_normal(
            (b, g.n_bins, g.n_frames)).astype(np.float32)).cuda()
        g_part = torch.from_numpy(rng.uniform(0.5, 1.5, (b, 3)).astype(
            np.float32)).cuda()
        runs = {
            "spectral_mag_fwd": (lambda: cdm.spectral_mag_fwd(x, *geo),
                                 lambda: cdm.spectral_mag_plain(x, *geo)),
            "spectral_mag_bwd": (
                lambda: cdm.spectral_mag_bwd(x, g_mag, *geo),
                lambda: cdm.spectral_mag_bwd_plain(x, g_mag, *geo)),
            "loss_partials_fwd": (
                lambda: cfl.loss_partials_fwd(x, y, *geo),
                lambda: cfl.loss_partials_plain(x, y, *geo)),
            "loss_partials_bwd": (
                lambda: cfl.loss_partials_bwd(x, y, g_part, *geo),
                lambda: cfl.loss_partials_bwd_plain(x, y, g_part, *geo)),
        }
        staging = {n: sp.dft_staging(n, hop, g.n_taps)[0] for n in (1, 2)}
        for name, (kernel, plain) in runs.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            abs_err, rel_err = _rel_err(got, want)
            check(bool(torch.isfinite(got).all()), f"{name} {geo} finite")
            if name.endswith("bwd"):
                cos = _cosine(got, want)
                check(rel_err < GRAD_MAX and cos > GRAD_COS,
                      f"{name} {geo}: gradient agrees")
            elif name == "loss_partials_fwd":
                torch.testing.assert_close(got, want, atol=0,
                                           rtol=PARTIALS_RTOL)
            else:
                torch.testing.assert_close(got, want, atol=MAG_ATOL,
                                           rtol=MAG_RTOL)
            ms = cuda_ms(torch, kernel, reps=5, warmup=1)
            numbers = {"B": b, "T": t, "ms": ms, "max_abs_err": abs_err,
                       "max_rel_err": rel_err, "exercises": what,
                       "staging": staging[2 if "partials" in name else 1],
                       "n_cols": g.n_cols, "n_shifts": g.n_shifts,
                       "shift_group": sp.adj_group(g.hop_width, g.n_shifts)}
            print(f"kernel {name} widened {n_fft}/{hop}/{win} B={b} T={t} "
                  f"({what}): " + json.dumps(numbers))
            out.setdefault(name, {})[f"{n_fft}/{hop}/{win}"] = numbers
    return out


def loss_kernel_phase(torch, np):
    """spectral_mag and loss_partials, forward and backward, against their
    plain versions at the train step's shapes, at the pp phase's
    microbatch (B = 32 / 4), at a two-host step's rank (B = 32 / 2), at
    the cp phase's whole batch (B = 4 of the
    fine_tune preset's 1536 frames) and at a ragged length; returns the
    JSON entries (timed at the train step's shapes)."""
    from svs_torch.losses import mrstft
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.ops.cuda import spectral as sp
    from svs_torch.utils.config import get_config

    fine = get_config("fine_tune")

    rng = np.random.default_rng(3)

    def wave(b, t):
        return torch.from_numpy((rng.standard_normal((b, t)) * 0.3).astype(
            np.float32)).cuda()

    def library(x, n_fft, hop, win):
        """cuFFT magnitudes: torch.stft with the centred window, reflect
        pad, then the clip (a composition of calls, used nowhere)."""
        s = torch.stft(x, n_fft, hop, win_length=win,
                       window=torch.hann_window(win, device=x.device),
                       center=True, pad_mode="reflect", return_complex=True)
        return torch.sqrt(torch.clamp(s.real ** 2 + s.imag ** 2, min=1e-8))

    def library_partials(x, y, *geo, mag=library):
        mx, my = mag(x, *geo), mag(y, *geo)
        d = my - mx
        return torch.stack([(d * d).sum((1, 2)), (my * my).sum((1, 2)),
                            (mx.log() - my.log()).abs().sum((1, 2))], -1)

    def composed_partials(x, y, *geo):
        """matmul_bf16's PyTorch composition, which the rounded instances
        replace on the card."""
        return library_partials(x, y, *geo, mag=mrstft._spectral_mag_matmul)

    names = ("spectral_mag_fwd", "spectral_mag_bwd", "loss_partials_fwd",
             "loss_partials_bwd")

    def zero_totals():
        return dict(ms=0.0, event_ms=0.0, plain_ms=0.0, library_ms=0.0,
                    bound_ms=0.0, formulation_bound_ms=0.0, max_abs_err=0.0,
                    shapes={})

    totals = {n: zero_totals() for n in names}
    # the rounded instances (matmul_bf16 on the card), their library the
    # composition they replace
    for n in names[2:]:
        totals[n]["rounded"] = zero_totals()
    cdm.reset_counts()
    cfl.reset_counts()
    for b, t, label in ((TRAIN_B, TRAIN_T, "step"),
                        (TRAIN_B // PP_MICRO, TRAIN_T, "pp_microbatch"),
                        (TRAIN_B // MH_HOSTS, TRAIN_T, "mh_rank"),
                        (CP_B, (fine.input_len - 1) * fine.hop_size, "cp"),
                        (3, 9_001, "ragged")):
        for n_fft, hop, win in RESOLUTIONS:
            geo = (n_fft, hop, win)
            x, y = wave(b, t), wave(b, t)
            mag = cdm.spectral_mag_fwd(x, *geo)
            g_mag = torch.randn(mag.shape, device="cuda",
                                generator=torch.Generator("cuda")
                                .manual_seed(n_fft))
            g_part = torch.from_numpy(rng.uniform(0.5, 1.5, (b, 3)).astype(
                np.float32)).cuda()
            xg = x.clone().requires_grad_()
            lib_mag = library(xg, *geo)
            lib_part = library_partials(xg, y, *geo)
            comp_part = composed_partials(xg, y, *geo)
            # (name, rounded instance, kernel, plain version, library)
            runs = [
                ("spectral_mag_fwd", False,
                 lambda: cdm.spectral_mag_fwd(x, *geo),
                 lambda: cdm.spectral_mag_plain(x, *geo),
                 lambda: library(x, *geo)),
                ("spectral_mag_bwd", False,
                 lambda: cdm.spectral_mag_bwd(x, g_mag, *geo),
                 lambda: cdm.spectral_mag_bwd_plain(x, g_mag, *geo),
                 lambda: torch.autograd.grad(lib_mag, xg, g_mag,
                                             retain_graph=True)),
                ("loss_partials_fwd", False,
                 lambda: cfl.loss_partials_fwd(x, y, *geo),
                 lambda: cfl.loss_partials_plain(x, y, *geo),
                 lambda: library_partials(x, y, *geo)),
                ("loss_partials_bwd", False,
                 lambda: cfl.loss_partials_bwd(x, y, g_part, *geo),
                 lambda: cfl.loss_partials_bwd_plain(x, y, g_part, *geo),
                 lambda: torch.autograd.grad(lib_part, xg, g_part,
                                             retain_graph=True)),
                ("loss_partials_fwd", True,
                 lambda: cfl.loss_partials_fwd(x, y, *geo, rounded=True),
                 lambda: cfl.loss_partials_plain(x, y, *geo, rounded=True),
                 lambda: composed_partials(x, y, *geo)),
                ("loss_partials_bwd", True,
                 lambda: cfl.loss_partials_bwd(x, y, g_part, *geo,
                                               rounded=True),
                 lambda: cfl.loss_partials_bwd_plain(x, y, g_part, *geo,
                                                     rounded=True),
                 lambda: torch.autograd.grad(comp_part, xg, g_part,
                                             retain_graph=True)),
            ]
            for name, rounded, kernel, plain, lib in runs:
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                abs_err, rel_err = _rel_err(got, want)
                line = (f"kernel {name}{' rounded' if rounded else ''} "
                        f"{label} B={b} T={t} res={n_fft}/"
                        f"{hop}/{win}: max_abs_err={abs_err:.3e} "
                        f"max_rel_err={rel_err:.3e}")
                if name.endswith("bwd"):
                    cos = _cosine(got, want)
                    line += f" cosine={cos:.7f}"
                    check(rel_err < GRAD_MAX and cos > GRAD_COS,
                          f"{name} {label} {n_fft}: gradient agrees")
                elif name == "loss_partials_fwd":
                    torch.testing.assert_close(got, want, atol=0,
                                               rtol=PARTIALS_RTOL)
                else:
                    torch.testing.assert_close(got, want, atol=MAG_ATOL,
                                               rtol=MAG_RTOL)
                check(bool(torch.isfinite(got).all()), f"{name} finite")
                tot = totals[name]["rounded"] if rounded else totals[name]
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
                if label != "step":
                    print(line)
                    continue
                bound, by, form = loss_bounds(name, sp.Geometry(b, t, *geo))
                ms, split = spec_kernel_ms(torch, kernel)
                times = {"ms": ms, "by_kernel": split,
                         "event_ms": cuda_ms(torch, kernel, reps=10),
                         "plain_ms": cuda_ms(torch, plain, reps=5),
                         "library_ms": device_ms(torch, lib, reps=10),
                         "bound_ms": bound, "bound_by": by,
                         "formulation_bound_ms": form}
                print(line + " times: " + json.dumps(times))
                for k in ("ms", "event_ms", "plain_ms", "library_ms",
                          "bound_ms", "formulation_bound_ms"):
                    tot[k] += times[k]
                tot["shapes"][f"{n_fft}/{hop}/{win}"] = times
            del lib_mag, lib_part, comp_part, xg

    for name in names:
        if name.endswith("bwd"):
            for shape, t in totals[name]["shapes"].items():
                print(f"kernel {name} {shape} launches: " + ", ".join(
                    f"{k} {v:.5f} ms" for k, v in t["by_kernel"].items()))

    # a weighted batch: weight [1, 0] drops row 1 out of all three sums
    x, y = wave(2, 20_000), wave(2, 20_000)
    w = torch.tensor([1.0, 0.0], device="cuda")
    a = cfl.stft_loss_fused(x, y, 1024, 120, 600, weight=w).item()
    one = cfl.stft_loss_fused(x[:1].contiguous(), y[:1].contiguous(), 1024,
                              120, 600).item()
    print(f"kernel loss_partials weight [1, 0]: {a:.7f} vs the single row "
          f"{one:.7f}")
    check(abs(a - one) <= 1e-6 * abs(one), "weight [1, 0] drops row 1")
    print(f"kernel check launches: spectral_mag {cdm.fwd_launches} fwd "
          f"{cdm.bwd_launches} bwd, loss_partials {cfl.fwd_launches} fwd "
          f"{cfl.bwd_launches} bwd")
    widened = widened_phase(torch, np, cdm, cfl, sp)

    sources = {"spectral_mag": ("svs_torch/csrc/diff_mag.cu",
                                ("svs_tpu/ops/pallas/diff_mag.py:130",
                                 "svs_tpu/ops/pallas/diff_mag.py:171")),
               "loss_partials": ("svs_torch/csrc/fused_loss.cu",
                                 ("svs_tpu/ops/pallas/fused_loss.py:327",
                                  "svs_tpu/ops/pallas/fused_loss.py:379"))}
    entries = []
    for name in names:
        tot = totals[name]
        src, (fwd_at, bwd_at) = sources[name.rsplit("_", 1)[0]]
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": fwd_at if name.endswith("fwd") else bwd_at,
            "launches": None,  # filled from the train phase
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            # what bounds the larger part of the three calls' sum
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                t["bound_ms"] for t in tot["shapes"].values()
                if t["bound_by"] == by)),
            "library_ms": tot["library_ms"],
            "event_ms": tot["event_ms"],
            "timing": ("ms: device time per call summed over the spec:: "
                       "kernels (torch.profiler, 10 calls); library_ms: "
                       "device time of all its kernels; event_ms and "
                       "plain_ms: CUDA events over back-to-back calls"),
            "library": "composition: torch.stft (cuFFT) magnitudes"
                       + (", the three sums" if "partials" in name else "")
                       + (", autograd backward" if name.endswith("bwd")
                          else ""),
            "formulation_bound_ms": tot["formulation_bound_ms"],
            "shape": {"B": TRAIN_B, "T": TRAIN_T,
                      "per": "one call at each of the three resolutions"},
            "shapes": tot["shapes"],
            "widened": widened[name],
        })
        if "rounded" in tot:
            # matmul_bf16's instances: the same work, the library the
            # composition they replace (a bf16 torch.matmul, the magnitude
            # and the sums as tensor ops, autograd's backward)
            entries[-1]["rounded"] = {
                k: tot["rounded"][k] for k in (
                    "ms", "event_ms", "plain_ms", "library_ms",
                    "max_abs_err", "shapes")}
    return entries


def train_phase(torch, np, spec: str):
    """Four steps from one seeded full-width state under each mr_mag_impl,
    through ``make_train_step``'s cached program (the first call its eager
    warm-up step, the second its capture and first replay); returns
    (per loss kernel, summed over the kernel paths: the wrappers' eager
    launches, their calls recorded into the captures, and the launches of
    one more replayed step, read from its trace; first batch)."""
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.train import graphs
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = list(ds.batches(TRAIN_B, seed=0, n_steps=4))
    batches = [tstep.batch_to_device(b, "cuda") for b in host]
    total = {k: {"eager": 0, "captured": 0, "traced_replay": 0}
             for k in LOSS_NAMES}
    first_mr, first_gn = {}, {}
    for impl in (COMPOSITION,) + IMPLS:
        # the composition's program has matmul_bf16's key: none is kept
        _route_to_kernels(impl != COMPOSITION)
        graphs.CACHE.clear()
        cfg = dataclasses.replace(get_config("default"), mr_mag_impl=(
            "matmul_bf16" if impl == COMPOSITION else impl))
        state = tstep.create_train_state(0, cfg, device="cuda")
        step = tstep.make_train_step(cfg)
        gen = torch.Generator("cuda").manual_seed(1)
        cdm.reset_counts()
        cfl.reset_counts()
        ms, metrics = [], []
        for batch in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch, gen)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            metrics.append({k: float(v) for k, v in m.items()})
        counts, captured = _loss_counts()
        per = LOSS_PER_STEP[impl]
        check(counts == per and captured == per,
              f"{impl}: kernel launches {counts} and captured calls "
              f"{captured} == {per} (spectral_mag fwd/bwd, loss_partials "
              "fwd/bwd): the warm-up step, then one capture")
        for m in metrics:
            check(all(math.isfinite(v) for v in m.values()),
                  f"{impl}: finite losses and grad_norm")
        first_mr[impl] = metrics[0]["mr"]
        first_gn[impl] = metrics[0]["grad_norm"]
        traced = {}
        busy = device_breakdown(
            torch, lambda: step(state, batches[3], gen),
            f"train {impl} step (a replay)",
            (("loss_kernels", ("spec::",)),) + FAMILIES, kernels=traced)
        replayed = tuple(traced.get(k, 0) for k in LOSS_NAMES)
        check(replayed == per, f"{impl}: a traced replay launched the loss "
              f"kernels {replayed} == {per}")
        for i, name in enumerate(LOSS_NAMES):
            total[name]["eager"] += counts[i]
            total[name]["captured"] += captured[i]
            total[name]["traced_replay"] += replayed[i]
        steady = sum(ms[2:]) / len(ms[2:])
        print(f"train {impl}: ms per call {[round(v, 3) for v in ms]} "
              f"(warm-up step, capture and replay, replays: mean "
              f"{steady:.3f}); device busy {busy:.3f} ms, idle share "
              f"{1.0 - busy / steady:.3f}; wrapper launches {list(counts)}, "
              f"captured {list(captured)}, a replay's {list(replayed)}; "
              f"metrics step 1 {json.dumps(metrics[0])}, step 4 "
              f"{json.dumps(metrics[3])}")
        del state, step
    _route_to_kernels(True)
    graphs.CACHE.clear()
    base_mr, base_gn = first_mr[COMPOSITION], first_gn[COMPOSITION]
    for impl in IMPLS:
        rel = abs(first_mr[impl] - base_mr) / abs(base_mr)
        print(f"train {impl}: first-step mr {first_mr[impl]:.7f} vs the "
              f"composition's {base_mr:.7f}, rel {rel:.2e} (bound "
              f"{MR_RTOL:g})")
        check(rel < MR_RTOL, f"{impl}: first-step mr near the composition's")
        gn = abs(first_gn[impl] - base_gn) / base_gn
        print(f"train {impl}: first-step grad_norm {first_gn[impl]:.7f} vs "
              f"the composition's {base_gn:.7f}, rel {gn:.2e} (bound "
              f"{GN_RTOL:g})")
        check(gn < GN_RTOL,
              f"{impl}: first-step grad_norm near the composition's")
    return total, host[0]


# fit: patches a song at B = 32 (3 songs: 3 steps an epoch)
FIT_SAMPLES = 32


def _read_lines(path: str):
    with open(path) as f:
        return f.read().splitlines()


def fit_phase(torch, np, work: str):
    """The training entry point at the full default preset on the slice's
    spectra; returns, per loss kernel, summed over the ``fit`` runs under
    the kernel paths: the wrappers' launches (the program's eager warm-up
    step) and calls recorded into its capture (each zeroed just before the
    fit and read just after), and the replays' launches (a torch.profiler
    trace of the fit, less the eager launches)."""
    from svs_torch.cli import infer_cli, train_cli
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.train import checkpoint as ckpt
    from svs_torch.train import flax_msgpack
    from svs_torch.train import graphs
    from svs_torch.train import loop
    from svs_torch.train import step as tstep
    from svs_torch.models.unet import param_count
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    ckpt_dir, log_dir = os.path.join(work, "CKPT"), os.path.join(work, "LOG")
    numbers = {}
    common = ["--train_folder", spec, "--valid_folder", spec,
              "--batch_size", str(TRAIN_B), "--samples_per_song",
              str(FIT_SAMPLES), "--val_interval", "1", "--label", "smoke",
              "--ckpt_dir", ckpt_dir, "--log_dir", log_dir,
              "--device", "cuda", "--preset", "default"]
    steps = -(-N_SONGS * FIT_SAMPLES // TRAIN_B)

    t0 = time.perf_counter()
    rc = train_cli.main(common + ["--epoch", "2", "--load_path",
                                  os.path.join(work, "none.ckpt")])
    numbers["train_cli_2_epochs_s"] = time.perf_counter() - t0
    check(rc == 0, "train_cli exit code 0")
    log = _read_lines(os.path.join(log_dir, "log_smoke.txt"))
    print("fit: train_cli log " + json.dumps(log))
    check(len(log) == 4 and [x.startswith("Val ") for x in log]
          == [False, True, False, True]
          and all(math.isfinite(float(x.split()[-1])) for x in log),
          "train_cli log: a finite loss per epoch, each with a Val line")
    metrics = [json.loads(x) for x in _read_lines(
        os.path.join(log_dir, "metrics_smoke.jsonl"))]
    check(all(math.isfinite(v) for r in metrics for v in r.values()),
          "metrics lines finite")
    numbers["epoch_s"] = [r["secs"] for r in metrics if "secs" in r]
    latest = os.path.join(ckpt_dir, "svs_smoke.ckpt")
    check(os.path.exists(latest) and os.path.exists(
        os.path.join(ckpt_dir, "svs_best_smoke.ckpt")),
        "svs_best_smoke.ckpt and svs_smoke.ckpt written")

    def saved(path):
        with open(path, "rb") as f:
            raw = flax_msgpack.unpackb(f.read())
        return raw["epoch"], raw["step"]

    check(saved(latest) == (2, 2 * steps), f"latest ckpt at epoch 2, step "
          f"{2 * steps}: {saved(latest)}")
    t0 = time.perf_counter()
    rc = train_cli.main(common + ["--epoch", "3", "--load_path", latest])
    numbers["resume_1_epoch_s"] = time.perf_counter() - t0
    check(rc == 0 and saved(latest) == (3, 3 * steps),
          f"resume carried on to epoch 3, step {3 * steps}: {saved(latest)}")
    print(f"fit: resumed from epoch 2 to {saved(latest)}")

    masked = os.path.join(work, "masked_ckpt")
    rc = infer_cli.main(["--model_path", latest, "--tar", masked,
                         "--mixture_folder", os.path.join(spec, "mixture"),
                         "--preset", "default", "--limit", "1",
                         "--device", "cuda"])
    check(rc == 0, "infer_cli from the .ckpt exit code 0")
    out = np.load(os.path.join(masked, "0000_song0_spec.npy"))
    mix = np.load(os.path.join(spec, "mixture", "0000_song0_spec.npy"))
    check(out.shape == mix.shape and np.isfinite(out).all()
          and (out[1:] <= mix[1:] + 1e-6).all(),
          "infer_cli from the .ckpt: shape, finite, |mask| <= 1")

    # fit under each loss path, one epoch, no dropout, one seeded state;
    # its steps are make_train_step's program (the first its eager warm-up
    # step, the second its capture), so the replays' launches are read from
    # a torch.profiler trace of the fit
    launches = {k: [0, 0, 0] for k in LOSS_NAMES}
    means = {}
    for impl in (COMPOSITION, "matmul_bf16", "pallas_fused", "pallas_bf16"):
        # the composition's programs have matmul_bf16's keys: none is kept
        _route_to_kernels(impl != COMPOSITION)
        graphs.CACHE.clear()
        cfg = dataclasses.replace(get_config("default"), mr_mag_impl=(
            "matmul_bf16" if impl == COMPOSITION else impl),
            dropout_rate=0.0, samples_per_song=FIT_SAMPLES)
        opts = loop.TrainOptions(
            train_folder=spec, valid_folder="none", label=f"fit_{impl}",
            epoch=1, batch_size=TRAIN_B, load_path="none",
            ckpt_dir=ckpt_dir, log_dir=log_dir, progress=False,
            device="cuda")
        cdm.reset_counts()
        cfl.reset_counts()
        result = {}
        events = device_events(torch, lambda: result.setdefault(
            "state", loop.fit(opts, cfg)))
        state = result["state"]
        counts, captured = _loss_counts()
        seen = {}
        for key, _, n in events:
            if _kernel_of(key):
                seen[_kernel_of(key)] = seen.get(_kernel_of(key), 0) + n
        per = LOSS_PER_STEP[impl]
        traced = tuple(seen.get(k, 0) for k in LOSS_NAMES)
        want = tuple(steps * n for n in per)
        check(counts == per and captured == per and traced == want,
              f"fit {impl}: wrapper launches {counts} (the warm-up step) and "
              f"captured calls {captured} == {per}, the fit's trace "
              f"{traced} == {want} (spectral_mag fwd/bwd, loss_partials "
              "fwd/bwd)")
        for i, name in enumerate(LOSS_NAMES):
            launches[name][0] += counts[i]
            launches[name][1] += captured[i]
            launches[name][2] += traced[i] - counts[i]
        log = _read_lines(os.path.join(log_dir, f"log_fit_{impl}.txt"))
        means[impl] = float(log[0])
        print(f"fit {impl}: epoch mean loss {means[impl]:.7f}, wrapper "
              f"launches {list(counts)}, captured {list(captured)}, the "
              f"fit's trace {list(traced)}, params "
              f"{param_count(state.model)}")
        check(param_count(state.model) == 9_823_313, "full-width default")
        del state, result
    _route_to_kernels(True)
    graphs.CACHE.clear()
    for impl in ("matmul_bf16", "pallas_fused", "pallas_bf16"):
        rel = abs(means[impl] - means[COMPOSITION]) / abs(means[COMPOSITION])
        print(f"fit {impl}: epoch mean loss vs the composition's rel "
              f"{rel:.2e} (bound {MR_RTOL:g})")
        check(rel < MR_RTOL, f"fit {impl}: mean loss near the composition's")

    # the device's busy share of an epoch: two fit calls traced, one
    # epoch and none (the same set-up: the dataset's upload, the state),
    # the difference of their device time over the epoch's seconds
    cfg = dataclasses.replace(get_config("default"),
                              samples_per_song=FIT_SAMPLES)
    busy = {}
    for epochs in (1, 0):
        opts = loop.TrainOptions(
            train_folder=spec, valid_folder="none",
            label=f"fit_traced{epochs}", epoch=epochs, batch_size=TRAIN_B,
            load_path="none", ckpt_dir=ckpt_dir, log_dir=log_dir,
            progress=False, device="cuda")
        busy[epochs] = sum(ms for _, ms, _ in device_events(
            torch, lambda: loop.fit(opts, cfg)))
    traced = [json.loads(x) for x in _read_lines(
        os.path.join(log_dir, "metrics_fit_traced1.jsonl"))][0]["secs"]
    epoch_busy = busy[1] - busy[0]
    numbers.update(traced_epoch_s=traced, traced_epoch_busy_ms=epoch_busy,
                   traced_setup_busy_ms=busy[0],
                   traced_idle_share=1.0 - epoch_busy / (traced * 1e3))
    print(f"fit: one traced epoch of {steps} steps at B={TRAIN_B}: "
          f"{traced:.3f} s, device busy {epoch_busy:.3f} ms (fit calls of "
          f"one epoch and none: {busy[1]:.3f} - {busy[0]:.3f}), idle share "
          f"{numbers['traced_idle_share']:.3f}")

    # remat: one fine_tune step with and without, same state and masks
    cfg = get_config("fine_tune")
    rng = np.random.default_rng(8)
    b = 4
    mix = rng.random((b, 512, cfg.input_len)).astype(np.float32)
    batch = {"mix": mix, "voc": (mix * rng.random(mix.shape)).astype(
        np.float32)}
    for k in ("mix_angle", "voc_angle"):
        batch[k] = rng.uniform(-np.pi, np.pi, mix.shape).astype(np.float32)
    batch = tstep.batch_to_device(batch, "cuda")
    res = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state = tstep.create_train_state(0, c, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        _, m = tstep.make_train_step(c)(
            state, batch, torch.Generator("cuda").manual_seed(1))
        res[remat] = ({k: float(v) for k, v in m.items()},
                      torch.cuda.max_memory_allocated() / 2**20)
        del state
    (m0, mem0), (m1, mem1) = res[False], res[True]
    loss_rel = abs(m1["total"] - m0["total"]) / abs(m0["total"])
    gn_rel = abs(m1["grad_norm"] - m0["grad_norm"]) / m0["grad_norm"]
    print(f"fit: fine_tune step B={b} x {cfg.input_len} frames, remat vs "
          f"not: total {m1['total']:.7f} vs {m0['total']:.7f} (rel "
          f"{loss_rel:.2e}), grad_norm rel {gn_rel:.2e}; peak memory "
          f"{mem1:.0f} vs {mem0:.0f} MiB")
    check(loss_rel <= 1e-6, "remat: the same loss")
    check(gn_rel < GN_RTOL, "remat: the same grad_norm")
    numbers.update(remat_peak_mib=mem1, no_remat_peak_mib=mem0)
    print("fit numbers: " + json.dumps(numbers))
    return launches


# step graph: the train and eval steps as cached captured programs
# (train/graphs.py) under the three loss paths, against their eager bodies
STEP_IMPLS = ("matmul_bf16", "pallas_bf16", "pallas_fused")
STEP_TAIL_B = 20   # a ragged tail batch's rows
STEP_WEIGHTED = 8  # padding rows of the weighted batch (weight 0)


def _max_diff(torch, a, b) -> float:
    """The largest |a - b| over two equally long sequences of tensors."""
    return max(((x.double() - y.double()).abs().max().item()
                for x, y in zip(a, b)), default=0.0)


def step_graph_phase(torch, np, work: str) -> dict:
    """``make_train_step`` / ``make_eval_step`` on the card: each call the
    cached captured program of its key (``train/graphs.py``), against the
    eager bodies (``make_step_fn`` / ``make_eval_fn``) from one seeded
    state with the same (capturable) Adam and dropout generator seed.
    Returns, per loss kernel, summed over the program calls of the
    ``mr_mag_impl`` runs (traced by torch.profiler): the wrappers' eager
    launches in the programs' warm-up steps, the calls recorded into their
    captures, and the replays' launches (the trace's less every wrapper
    launch in it)."""
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.parallel import dp
    from svs_torch.train import graphs
    from svs_torch.train import loop
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    batches = [tstep.batch_to_device(b, "cuda")
               for b in ds.batches(TRAIN_B, seed=7, n_steps=4)]
    tail = {k: v[:STEP_TAIL_B] for k, v in batches[0].items()}
    weight = torch.ones(TRAIN_B, device="cuda")
    weight[-STEP_WEIGHTED:] = 0.0
    weighted = dict(batches[1], weight=weight)
    default = get_config("default")
    line = {"device": nvidia_smi_line()}
    counts = {k: {"eager": 0, "captured": 0, "replayed": 0}
              for k in LOSS_NAMES}
    t_phase = time.perf_counter()

    def programs_of(state):
        return [p for p in graphs.CACHE._programs.values()
                if p.model() is state.model]

    def run(label, cfg, calls, accum=1, lr_at=None, traced=None):
        """The program and the eager body from one seeded state over
        ``calls`` (the learning rate dropped before call ``lr_at``): the
        same metrics and state bits, one step a call.  ``traced``: a dict
        that takes the loss kernels' launches in a torch.profiler trace of
        the calls (the eager body's are read from the wrappers' counts,
        which the returned ``body_launches`` holds)."""
        opt = tstep.make_optimizer(cfg, accum)
        eager, prog = (tstep.create_train_state(0, cfg, opt, device="cuda")
                       for _ in range(2))
        body, step = tstep.make_step_fn(cfg), tstep.make_train_step(cfg)
        ge, gp = (torch.Generator("cuda").manual_seed(1) for _ in range(2))
        m_diff, secs, body_launches = 0.0, [], [0, 0, 0, 0]

        def all_calls():
            nonlocal eager, prog, m_diff
            for i, batch in enumerate(calls):
                if i == lr_at:
                    for s in (eager, prog):
                        tstep.set_learning_rate(s, cfg.lr_after_drop)
                before = _loss_counts()[0]
                eager, want = body(eager, batch, ge)
                body_launches[:] = [a + n - b for a, n, b in zip(
                    body_launches, _loss_counts()[0], before)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prog, got = step(prog, batch, gp)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                m_diff = max(m_diff, _max_diff(
                    torch, [got[k] for k in want], list(want.values())))

        if traced is None:
            all_calls()
        else:
            # device_events takes a trace again if it held no device time:
            # the calls run once
            for key, _, n in device_events(
                    torch, lambda: None if secs else all_calls()):
                if _kernel_of(key) in LOSS_NAMES:
                    traced[_kernel_of(key)] = traced.get(_kernel_of(key),
                                                         0) + n
        s_diff = _max_diff(torch, dp._state_tensors(eager),
                           dp._state_tensors(prog))
        progs = programs_of(prog)
        r = dict(metrics_max_diff=m_diff, state_max_diff=s_diff,
                 programs=[(p.captures, p.replays) for p in progs])
        print(f"step graph {label}: {len(calls)} program calls against the "
              f"eager body: metrics max diff {m_diff:g}, state (parameters, "
              f"BN, Adam) max diff {s_diff:g}; programs (captures, replays) "
              f"{r['programs']}; call seconds "
              f"{[round(v, 4) for v in secs]}")
        check(m_diff == 0.0 and s_diff == 0.0
              and prog.step == eager.step == len(calls),
              f"step graph {label}: the eager body's bits, one step a call")
        line[label] = r
        return eager, prog, (body, step, ge, gp), secs, progs, tuple(
            body_launches)

    def evals(label, cfg, eager, prog):
        d = 0.0
        for batch in (batches[2], tail):
            for _ in range(2):
                got = tstep.make_eval_step(cfg)(prog, batch)
                want = tstep.make_eval_fn(cfg)(eager, batch)
                d = max(d, _max_diff(torch, [got[k] for k in want],
                                     list(want.values())))
        print(f"step graph {label} eval: B={TRAIN_B} and {STEP_TAIL_B}, two "
              f"calls each, max diff {d:g} from the eager eval")
        check(d == 0.0, f"step graph {label}: eval programs give the eager "
              "eval's bits")
        line[label]["eval_max_diff"] = d

    graphs.CACHE.clear()
    for impl in STEP_IMPLS:
        cfg = dataclasses.replace(default, mr_mag_impl=impl)
        per = LOSS_PER_STEP[impl]
        cdm.reset_counts()
        cfl.reset_counts()
        calls = batches + [tail, tail]
        seen = {}
        eager, prog, (body, step, ge, gp), secs, progs, body_n = run(
            impl, cfg, calls, traced=seen)
        got, rec = _loss_counts()
        # the programs' eager launches: their warm-up steps (the full
        # batch's and the tail's); captured: the two programs' captures;
        # replayed: three replays of the full batch's program, one of the
        # tail's
        prog_n = tuple(g - b for g, b in zip(got, body_n))
        rep_n = tuple(seen.get(k, 0) - g for k, g in zip(LOSS_NAMES, got))
        print(f"step graph {impl}: loss kernel launches (spectral_mag "
              f"fwd/bwd, loss_partials fwd/bwd): the eager body's "
              f"{list(body_n)}, the programs' warm-up steps' {list(prog_n)}, "
              f"captured {list(rec)}, the replays' {list(rep_n)} (the "
              f"trace's {[seen.get(k, 0) for k in LOSS_NAMES]} less the "
              "wrappers')")
        check(body_n == tuple(6 * v for v in per)
              and prog_n == tuple(2 * v for v in per)
              and rec == tuple(2 * v for v in per)
              and rep_n == tuple(4 * v for v in per),
              f"step graph {impl}: launches of the body {body_n}, the "
              f"warm-up steps {prog_n}, captured {rec}, replays {rep_n}")
        evals(impl, cfg, eager, prog)
        full = next(p for p in progs if p.input["mix"].shape[0] == TRAIN_B)
        check((full.captures, full.replays) == (1, 3),
              f"step graph {impl}: the full batch's program captured once")
        replay_ms = cuda_ms(torch, lambda: step(prog, batches[0], gp),
                            reps=20, warmup=2)
        eager_ms = cuda_ms(torch, lambda: body(eager, batches[0], ge),
                           reps=10, warmup=2)
        traced = {}
        busy = device_breakdown(
            torch, lambda: step(prog, batches[0], gp),
            f"step graph {impl} replay",
            (("loss_kernels", ("spec::",)),) + FAMILIES, kernels=traced)
        replayed = tuple(traced.get(k, 0) for k in LOSS_NAMES)
        check(replayed == per, f"step graph {impl}: a traced replay "
              f"launched the loss kernels {replayed} == {per}")
        for i, name in enumerate(LOSS_NAMES):
            counts[name]["eager"] += prog_n[i]
            counts[name]["captured"] += rec[i]
            counts[name]["replayed"] += rep_n[i]
        line[impl].update(
            replay_ms=replay_ms, eager_ms=eager_ms, replay_busy_ms=busy,
            replay_idle_share=1.0 - busy / replay_ms,
            warmup_call_s=secs[0], capture_call_s=secs[1],
            tail_capture_call_s=secs[5],
            program_bytes={f"{k[0]} B={p.input['mix'].shape[0]}": p.nbytes
                           for k, p in graphs.CACHE._programs.items()
                           if p.model() is prog.model},
            cache_bytes=graphs.CACHE.nbytes, cache_programs=len(graphs.CACHE))
        print(f"step graph {impl}: B={TRAIN_B} step ms replay "
              f"{replay_ms:.3f}, eager body {eager_ms:.3f} (CUDA events); "
              f"a traced replay busy {busy:.3f} ms, idle share "
              f"{1.0 - busy / replay_ms:.3f}; first call (eager warm-up) "
              f"{secs[0]:.3f} s, second (capture and replay) {secs[1]:.3f} "
              f"s; program bytes {line[impl]['program_bytes']}, the cache "
              f"{graphs.CACHE.nbytes} B in {len(graphs.CACHE)} programs")
        del eager, prog, body, step, progs, full

    # the other keys of the rules, one case each
    fused = dataclasses.replace(default, mr_mag_impl="pallas_fused")
    *_, progs, _ = run("accum_steps=2", dataclasses.replace(
        default, mr_mag_impl="pallas_bf16"), batches + batches[:2], accum=2)
    check(sorted(progs[0].graphs or ()) == [0, 1], "step graph "
          "accum_steps=2: a graph per cycle position, both replayed")
    *_, progs, _ = run("weighted", dataclasses.replace(
        default, mr_mag_impl="matmul_bf16"), [weighted] * 3)
    check("weight" in progs[0].input, "step graph weighted: its program")
    *_, progs, _ = run("lr change", fused, batches, lr_at=2)
    check(progs[0].captures == 2, "step graph lr change: captured again")
    ft = dataclasses.replace(get_config("fine_tune"),
                             mr_mag_impl="pallas_fused")
    rng = np.random.default_rng(8)
    shape = (4, 512, ft.input_len)
    mix = rng.random(shape, np.float32)
    ft_batch = tstep.batch_to_device(
        {"mix": mix, "voc": mix * rng.random(shape, np.float32),
         "mix_angle": rng.uniform(-np.pi, np.pi, shape).astype(np.float32),
         "voc_angle": rng.uniform(-np.pi, np.pi, shape).astype(np.float32)},
        "cuda")
    check(ft.remat, "fine_tune trains with remat")
    *_, secs, progs, _ = run("fine_tune remat", ft, [ft_batch] * 3)
    line["fine_tune remat"]["program_bytes"] = progs[0].nbytes
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        f32 = dataclasses.replace(default, compute_dtype="float32",
                                  mr_mag_impl="fft")
        eager, prog, *_ = run("float32 deterministic", f32, batches[:3])
        evals("float32 deterministic", f32, eager, prog)
        del eager, prog
    finally:
        torch.backends.cudnn.deterministic = was
    del progs
    line["seconds"] = {"steps": time.perf_counter() - t_phase}

    # two epochs of fit, the per-step loop and validation as programs,
    # against the same fit with the eager bodies
    t0 = time.perf_counter()
    cfg = dataclasses.replace(fused, samples_per_song=SCAN_SAMPLES)
    root = os.path.join(work, "step_graph")

    def opts(run_name):
        return loop.TrainOptions(
            train_folder=spec, valid_folder=spec, label="x", epoch=2,
            batch_size=TRAIN_B, load_path="none",
            ckpt_dir=os.path.join(root, run_name, "CKPT"),
            log_dir=os.path.join(root, run_name, "LOG"), progress=False,
            val_interval=1, device="cuda")

    fits = {name: _recording_fit(torch, opts(name), cfg,
                                 eager=name == "eager")
            for name in ("eager", "programs")}
    (s_e, l_e, _), (s_p, l_p, _) = fits["eager"], fits["programs"]
    logs = {k: _read_lines(os.path.join(root, k, "LOG", "log_x.txt"))
            for k in fits}
    secs = {k: [json.loads(x)["secs"] for x in _read_lines(
        os.path.join(root, k, "LOG", "metrics_x.jsonl")) if '"secs"' in x]
        for k in fits}
    bits = (np.array_equal(l_e, l_p) and logs["eager"] == logs["programs"]
            and _same_bits(torch, _full_state(torch, s_e),
                           _full_state(torch, s_p)))
    print(f"step graph fit: 2 epochs of {len(l_p) // 2} steps (a tail of "
          f"{N_SONGS * SCAN_SAMPLES % TRAIN_B}) with validation, "
          f"pallas_fused: programs against eager bodies, step losses, text "
          f"log and final state the same bits {bits}; epoch seconds "
          f"programs {secs['programs']}, eager {secs['eager']}")
    check(bits and len(l_p) == 2 * -(-N_SONGS * SCAN_SAMPLES // TRAIN_B),
          "step graph fit: the program fit is the eager fit, bit for bit")
    line["fit"] = dict(same_bits=bits, epoch_s=secs)
    line["seconds"]["fits"] = time.perf_counter() - t0
    del fits, s_e, s_p
    print("step graph: " + json.dumps(line))
    return counts


# scan: patches a song at B = 32 (3 songs, 105 patches: 3 full steps and a
# ragged tail of 9 an epoch), 2 epochs with the learning-rate drop at the
# second and validation at its end
SCAN_SAMPLES = 35
SCAN_EPOCHS = 2
# graph replay against the eager step, per-step losses: the same kernels on
# the same inputs and the same (capturable) Adam, so the same bits on the
# H100; the bound is the acceptance's
SCAN_LOSS_RTOL = 1e-5
# per step: (spectral_mag fwd, bwd, loss_partials fwd, bwd) wrapper calls
# (matmul_bf16 on the card: the loss_partials kernels' rounded instances)
LOSS_PER_STEP = {"matmul_bf16": (0, 0, 3, 3), "pallas_fused": (0, 0, 3, 3),
                 "pallas_fused_wide": (0, 0, 3, 3),
                 "pallas_bf16": (6, 3, 0, 0), COMPOSITION: (0, 0, 0, 0)}
LOSS_NAMES = ("spectral_mag_fwd", "spectral_mag_bwd", "loss_partials_fwd",
              "loss_partials_bwd")


def _kernel_of(name: str):
    """A loss kernel's profiler name -> (function, direction) or None:
    ``spec::dft_wgmma<NSIG, EPI, FRAG>`` (NSIG 1 spectral_mag, 2
    loss_partials; EPI 0/1 forward, 2/3 backward) and the backward's
    ``spec::adjoint_wgmma``."""
    if "spec::dft_wgmma<" in name:
        nsig, epi = (int(v) for v in
                     name.split("dft_wgmma<")[1].split(",")[:2])
        fn = "spectral_mag" if nsig == 1 else "loss_partials"
        return f"{fn}_{'fwd' if epi < 2 else 'bwd'}"
    if "spec::adjoint_wgmma<" in name:
        return "adjoint"
    return None


def _loss_counts():
    """The loss kernels' wrapper counts: (launches, calls captured into a
    graph), each in LOSS_NAMES order."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    return ((cdm.fwd_launches, cdm.bwd_launches, cfl.fwd_launches,
             cfl.bwd_launches),
            (cdm.fwd_captured, cdm.bwd_captured, cfl.fwd_captured,
             cfl.bwd_captured))


def _recording_fit(torch, opts, cfg, eager=False, trace=False,
                   stop=False):
    """``loop.fit(opts, cfg)`` with every step's ``total`` recorded in
    order (the per-step loop's, the scan's tail included, and each graph
    epoch's loss vector).  ``eager``: the train and eval steps as their
    eager bodies, not the cached programs (``train/graphs.py``);
    ``trace``: the whole fit under torch.profiler, its loss kernels'
    device launches counted by ``_kernel_of``; ``stop``: SIGTERM during
    the first epoch, and the fit's exit code kept.  Returns (state,
    losses, seen): ``seen`` holds the epoch function and its last
    arguments, the traced launches and the exit code."""
    import signal

    from torch.profiler import ProfilerActivity, profile

    from svs_torch.train import graphs, loop
    from svs_torch.train import scan

    totals, seen = [], {}
    make_step, make_scan = loop.make_train_step, scan.make_epoch_scan
    programmed = graphs.programmed

    def step_factory(c):
        step = make_step(c)

        def run(state, batch, gen=None):
            state, m = step(state, batch, gen)
            totals.append(m["total"].reshape(1))
            return state, m
        return run

    def scan_factory(*a, **k):
        epoch = make_scan(*a, **k)
        seen["epoch"] = epoch

        def run(*args):
            if stop:
                os.kill(os.getpid(), signal.SIGTERM)
            state, losses = epoch(*args)
            seen["args"] = args
            totals.append(losses)
            return state, losses
        return run

    loop.make_train_step, scan.make_epoch_scan = step_factory, scan_factory
    if eager:
        graphs.programmed = lambda dev: False
    prof = profile(activities=[ProfilerActivity.CUDA]) if trace else None
    state = None
    try:
        with prof if trace else contextlib.nullcontext():
            try:
                state = loop.fit(opts, cfg)
            except SystemExit as e:
                if not stop:
                    raise
                seen["code"] = e.code
            torch.cuda.synchronize()
    finally:
        loop.make_train_step, scan.make_epoch_scan = make_step, make_scan
        graphs.programmed = programmed
    if trace:
        kernels = {}
        for ev in prof.key_averages():
            k = _kernel_of(ev.key)
            if k and ev.device_type == torch.autograd.DeviceType.CUDA:
                kernels[k] = kernels.get(k, 0) + ev.count
        seen["kernels"] = kernels
    losses = torch.cat(totals).cpu().numpy() if totals else None
    return state, losses, seen


def _param_envelope(torch, a, b, lr: float):
    d = torch.cat([(p - q).abs().flatten().float() for p, q in
                   zip(a.model.parameters(), b.model.parameters())])
    return d.max().item(), d.mean().item(), 2.1 * lr


def _graph_vs_eager(torch, np, label, eager, graphed, lr, bits=False):
    """Per-step losses and parameters of a graph run against the per-step
    run of the same fit; prints and checks (``bits``: the same bits, as a
    replay runs the step's kernels in its order on the same Adam);
    returns the largest relative difference of a step's loss."""
    (s_e, l_e, _), (s_g, l_g, _) = eager, graphed
    check(l_e.shape == l_g.shape and np.isfinite(l_g).all(),
          f"{label}: {l_e.shape} step losses either way, finite")
    rel = float(np.max(np.abs(l_g - l_e) / np.abs(l_e)))
    pmax, pmean, bound = _param_envelope(torch, s_e, s_g, lr)
    print(f"{label}: {len(l_e)} step losses graph vs per step, max rel diff "
          f"{rel:.3e} (bound {SCAN_LOSS_RTOL:g}); params max |d| "
          f"{pmax:.3e} (bound {bound:.3e}), mean {pmean:.3e} (bound 2e-4); "
          f"the same bits {rel == 0.0 and pmax == 0.0}")
    check(rel <= SCAN_LOSS_RTOL, f"{label}: step losses within "
          f"{SCAN_LOSS_RTOL:g} relative of the per-step run's")
    check(s_e.step == s_g.step, f"{label}: the same step count")
    check(pmax <= bound and pmean < 2e-4,
          f"{label}: parameters within the envelope")
    if bits:
        check(rel == 0.0 and pmax == 0.0, f"{label}: the per-step run's "
              "losses and parameters, bit for bit")
    return rel


def scan_phase(torch, np, work: str):
    """``fit(epoch_scan=True)``, the whole epoch as replays of a captured
    CUDA graph, against the per-step fit (each step the cached program of
    ``make_train_step``, ``train/graphs.py``; the same capturable Adam)
    under each loss path.  The graph fits run under torch.profiler, so the
    loss kernels' launches in their replays are counted in the fit itself.
    Returns, per loss kernel, summed over the graph fits under the kernel
    paths: the wrappers' eager launches (the warm-up step, the first
    epoch's tail, validation's warm-up calls) and calls recorded into a
    graph (the epoch's two captures, the tail's program and validation's),
    each count zeroed just before the fit and read just after, and the
    replays' launches (the profiler's count less the eager launches); and
    the phase's numbers."""
    from svs_torch.data.device_data import gather_crops
    from svs_torch.evaluation import bss_torch
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.train import checkpoint as ckpt
    from svs_torch.train import flax_msgpack
    from svs_torch.train import loop
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    ckpt_dir, log_dir = os.path.join(work, "CKPT"), os.path.join(work, "LOG")
    n_full = N_SONGS * SCAN_SAMPLES // TRAIN_B
    check(n_full == 3 and N_SONGS * SCAN_SAMPLES % TRAIN_B,
          "3 full steps and a ragged tail an epoch")
    n_val = -(-N_SONGS * SCAN_SAMPLES // TRAIN_B)

    def opts(label, **kw):
        base = dict(train_folder=spec, valid_folder=spec, label=label,
                    epoch=SCAN_EPOCHS, batch_size=TRAIN_B, load_path="none",
                    ckpt_dir=ckpt_dir, log_dir=log_dir, progress=False,
                    device_data="on", val_interval=SCAN_EPOCHS,
                    save_every=SCAN_EPOCHS, device="cuda")
        base.update(kw)
        return loop.TrainOptions(**base)

    def config(impl, **kw):
        return dataclasses.replace(get_config("default"), mr_mag_impl=impl,
                                   samples_per_song=SCAN_SAMPLES,
                                   lr_drop_epoch=1, **kw)

    lr = get_config("default").learning_rate
    # matmul_bf16 without dropout and from one .ckpt, so that its graph fit
    # is also the uninterrupted run the resume is held against (a resumed
    # run draws dropout from its seed again, and its Adam takes the file's
    # float32 betas); the kernel paths with dropout, their masks drawn from
    # the generator the graph registers
    init = os.path.join(ckpt_dir, "scan_init.ckpt")
    ckpt.save(init, tstep.create_train_state(
        0, config("matmul_bf16"), device="cuda"))
    runs = {"matmul_bf16": dict(dropout_rate=0.0),
            "pallas_bf16": {}, "pallas_fused": {}}
    numbers, calls, captured, replayed = {}, {}, {}, {}
    for impl, cfg_kw in runs.items():
        cfg = config(impl, **cfg_kw)
        load = dict(load_path=init) if cfg_kw else {}
        t0 = time.perf_counter()
        eager = _recording_fit(torch, opts(f"eager_{impl}", **load), cfg)
        t1 = time.perf_counter()
        cdm.reset_counts()
        cfl.reset_counts()
        # traced: every path runs loss kernels (matmul_bf16 the rounded
        # instances)
        graphed = _recording_fit(
            torch, opts(f"scan_{impl}", epoch_scan=True, val_sdr=True,
                        **load), cfg, trace=True)
        t2 = time.perf_counter()
        got, rec = _loss_counts()
        epoch, args = graphed[2]["epoch"], graphed[2]["args"]
        seen = graphed[2].get("kernels", {})
        # eager launches: the epoch graph's warm-up step, the first
        # epoch's tail (its program's warm-up step) and validation's
        # programs' warm-up calls (2 each: the full batches' and the
        # tail's); captured: the epoch graph's two captures (the rate drops
        # at the second epoch), the tail's program at the second epoch and
        # validation's two; replayed: the rest of the epochs' steps, the
        # second tail and the validation batches
        per = LOSS_PER_STEP[impl]
        n_rep = SCAN_EPOCHS * n_full - 1
        eager_steps, val_eager = 2, 2 * 2
        want = tuple(v * (eager_steps + (val_eager if i % 2 == 0 else 0))
                     for i, v in enumerate(per))
        want_rec = tuple(v * (3 + (2 if i % 2 == 0 else 0))
                         for i, v in enumerate(per))
        eager_by_kernel = dict(zip(LOSS_NAMES, got))
        eager_by_kernel["adjoint"] = got[1] + got[3]
        rep = {k: n - eager_by_kernel[k] for k, n in seen.items()}
        per_kernel = dict(zip(LOSS_NAMES, per))
        per_kernel["adjoint"] = per[1] + per[3]
        want_rep = {k: (n_rep + 1) * v + (n_val * v if k.endswith("_fwd")
                                          else 0)
                    for k, v in per_kernel.items() if v}
        print(f"scan {impl}: fit {SCAN_EPOCHS} epochs per step "
              f"{t1 - t0:.2f} s, graph {t2 - t1:.2f} s (with val_sdr, "
              f"traced); captures {epoch.captures}, "
              f"replays {epoch.replays}; wrapper launches {list(got)} (want "
              f"{list(want)}), captured calls {list(rec)} (want "
              f"{list(want_rec)}); the fit's trace: loss kernels "
              f"{json.dumps(seen)}, replays' {json.dumps(rep)} (want "
              f"{json.dumps(want_rep)})")
        check(epoch.captures == 2, f"scan {impl}: captured at epoch 1 and "
              "again after the learning-rate drop")
        check(epoch.replays == n_rep, f"scan {impl}: {n_rep} replays")
        check(got == want and rec == want_rec,
              f"scan {impl}: wrapper launches {got} == {want}, captured "
              f"{rec} == {want_rec}")
        check(rep == want_rep, f"scan {impl}: the fit's replays ran the "
              f"loss kernels {rep} == {want_rep}")
        rel = _graph_vs_eager(torch, np, f"scan {impl}", eager, graphed, lr,
                              bits=True)
        if impl == "matmul_bf16":
            # the measurements below train the state on: keep the fit's end
            done = graphed[0]
            full = (types.SimpleNamespace(model=copy.deepcopy(done.model),
                                          step=done.step), graphed[1], None)
        val = [json.loads(x) for x in _read_lines(
            os.path.join(log_dir, f"metrics_scan_{impl}.jsonl"))][-1]
        check(val.get("sdr_songs") == N_SONGS
              and all(math.isfinite(val[f"vocal_{k}"])
                      for k in ("sdr", "sir", "sar", "nsdr")),
              f"scan {impl}: val_sdr wrote the vocal SDR fields {val}")
        calls[impl], captured[impl], replayed[impl] = got, rec, rep

        # measurements after the fit (its counts are read): the step's
        # time with the graph (replays of the last epoch's index matrices,
        # 3 steps a call) and eager (gather and the eager body, the
        # capturable Adam), by CUDA events, and the device's busy share of
        # one traced graph epoch
        state, planes, songs, starts, gen = args[:5]
        fn = lambda: epoch(state, planes, songs, starts, gen)  # noqa: E731
        graph_ms = cuda_ms(torch, fn, reps=5, warmup=1) / n_full
        busy = sum(ms for _, ms, _ in device_events(torch, fn))
        step = tstep.make_step_fn(cfg)
        host_form = tstep.create_train_state(0, cfg, device="cuda")
        s_t = torch.as_tensor(songs[0], dtype=torch.int64, device="cuda")
        st_t = torch.as_tensor(starts[0], dtype=torch.int64, device="cuda")
        eager_ms = cuda_ms(torch, lambda: step(
            host_form, gather_crops(planes, s_t, st_t, cfg.input_len), gen),
            reps=6, warmup=2)
        idle = 1.0 - busy / (graph_ms * n_full)
        numbers[impl] = dict(graph_step_ms=graph_ms, eager_step_ms=eager_ms,
                             graph_epoch_busy_ms=busy,
                             graph_idle_share=idle, loss_rel_diff=rel,
                             eager_fit_s=t1 - t0, graph_fit_s=t2 - t1)
        print(f"scan {impl}: step ms graph {graph_ms:.3f}, eager "
              f"{eager_ms:.3f} (CUDA events, B={TRAIN_B}); one graph epoch "
              f"of {n_full} replays: device busy {busy:.3f} ms, idle share "
              f"{idle:.3f}")
        del eager, graphed, state, step, host_form

    # SIGTERM under epoch_scan, served at the first epoch's end (exit 143),
    # then the resume from that .ckpt for the second epoch, against the
    # uninterrupted matmul_bf16 graph fit above
    cfg = config("matmul_bf16", dropout_rate=0.0)
    half = _recording_fit(torch, opts("half", epoch_scan=True,
                                      load_path=init), cfg, stop=True)
    with open(os.path.join(ckpt_dir, "svs_half.ckpt"), "rb") as f:
        raw = flax_msgpack.unpackb(f.read())
    print(f"scan SIGTERM: exit {half[2].get('code')}, checkpoint at epoch "
          f"{raw['epoch']}, step {raw['step']}")
    check(half[2].get("code") == 143
          and (raw["epoch"], raw["step"]) == (1, n_full + 1),
          "SIGTERM under epoch_scan: saved at the epoch's end, exit 143")
    resumed = _recording_fit(torch, opts(
        "half", epoch_scan=True,
        load_path=os.path.join(ckpt_dir, "svs_half.ckpt")), cfg)
    tail = (full[0], full[1][-(n_full + 1):], None)
    _graph_vs_eager(torch, np, "scan resume (epoch 2 from the SIGTERM "
                    ".ckpt vs uninterrupted)", tail, resumed, lr)
    del full, half, resumed, tail

    # accumulation (one graph per cycle position) with the remix
    # augmentation
    kw = dict(accum_steps=2, augment=True)
    cfg = config("matmul_bf16")
    eager = _recording_fit(torch, opts("e_accum_aug", **kw), cfg)
    graphed = _recording_fit(torch, opts("g_accum_aug", epoch_scan=True,
                                         **kw), cfg)
    _graph_vs_eager(torch, np, "scan accum_steps=2 with augment", eager,
                    graphed, lr)
    check(sorted(graphed[2]["epoch"].graphs) == [0, 1],
          "accum_steps=2: one graph per cycle position")
    del eager, graphed

    check(bss_torch.fallbacks == 0, "val_sdr: no BSS call fell back")
    print("scan numbers: " + json.dumps(numbers))
    kernel_paths = ("pallas_bf16", "pallas_fused")
    out = {}
    for i, name in enumerate(LOSS_NAMES):
        out[name] = {
            "scan_launches": sum(calls[p][i] for p in kernel_paths),
            "scan_captured": sum(captured[p][i] for p in kernel_paths),
            "replay_launches": sum(replayed[p].get(name, 0)
                                   for p in kernel_paths)}
    return out


def native_phase(torch, np, work: str) -> dict:
    """The port's C++ loader: native batches against numpy's, and a
    ``train_cli`` epoch from the host pipeline with 'auto' resolved to it."""
    from svs_torch.cli import train_cli
    from svs_torch.data import native
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.train import loop

    spec = os.path.join(work, "spec")
    seconds = {}
    t0 = time.perf_counter()
    check(native.available(), "the native library builds and loads")
    seconds["build_s"] = time.perf_counter() - t0
    check(os.path.dirname(native.SO_PATH).endswith(
        os.path.join("svs_torch", "_build")), "built under svs_torch/_build")
    nat = PatchDataset(spec, samples_per_song=FIT_SAMPLES, backend="native")
    ref = PatchDataset(spec, samples_per_song=FIT_SAMPLES, backend="numpy")
    n = 0
    for a, b in zip(nat.batches(TRAIN_B, seed=3), ref.batches(TRAIN_B,
                                                              seed=3)):
        for k in a:
            check(np.array_equal(a[k], b[k]),
                  f"native batch {k} equals numpy's")
        n += 1
    # the host pipeline's epoch of batches, each backend, best of 3
    for name, ds in (("native", nat), ("numpy", ref)):
        best = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            for _ in ds.batches(TRAIN_B, seed=4 + rep):
                pass
            best = min(best, time.perf_counter() - t0)
        seconds[f"{name}_epoch_batches_s"] = best
    backends = []
    make = loop._dataset

    def recording(folder, cfg):
        ds = make(folder, cfg)
        backends.append(ds.backend)
        return ds

    loop._dataset = recording
    t0 = time.perf_counter()
    try:
        rc = train_cli.main([
            "--label", "native", "--train_folder", spec, "--valid_folder",
            "none", "--batch_size", str(TRAIN_B), "--samples_per_song",
            str(FIT_SAMPLES), "--epoch", "1", "--device_data", "off",
            "--load_path", "none", "--ckpt_dir", os.path.join(work, "CKPT"),
            "--log_dir", os.path.join(work, "LOG"), "--device", "cuda"])
    finally:
        loop._dataset = make
    seconds["train_cli_epoch_s"] = time.perf_counter() - t0
    log = _read_lines(os.path.join(work, "LOG", "log_native.txt"))
    print(f"native: {n} batches of {TRAIN_B} bitwise equal to numpy's; "
          f"train_cli epoch on the host pipeline, backends {backends}, "
          f"loss {log}; seconds {json.dumps(seconds)}")
    check(rc == 0 and backends == ["native"] and math.isfinite(float(log[0])),
          "train_cli ran an epoch with 'auto' resolved to native")
    return seconds


def eval_phase(torch, np, work: str) -> dict:
    """``eval_cli --impl torch`` (f64 on the card) against ``--impl numpy``
    on the slice's separated wavs, and ``validation_sdr`` on the card."""
    import shutil

    from svs_torch.cli import eval_cli
    from svs_torch.evaluation import bss_torch
    from svs_torch.evaluation.val_sdr import validation_sdr
    from svs_torch.models.unet import UNet
    from svs_torch.utils.config import get_config

    mix, ref = os.path.join(work, "eval_mix"), os.path.join(work, "eval_ref")
    for d in (mix, ref):
        os.makedirs(d)
    for i in range(N_SONGS):
        song = os.path.join(work, "songs", f"song{i}")
        shutil.copy(os.path.join(song, "mixture.wav"),
                    os.path.join(mix, f"{i:04d}_song{i}.wav"))
        shutil.copy(os.path.join(song, "vocals.wav"),
                    os.path.join(ref, f"{i:04d}_song{i}.wav"))
    seconds, tables = {}, {}
    before = bss_torch.fallbacks
    for impl in ("torch", "numpy"):
        out = os.path.join(work, f"eval_{impl}.csv")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = eval_cli.main(["--est", os.path.join(work, "wav"), "--mix",
                                mix, "--ref", ref, "--impl", impl,
                                "--device", "cuda", "--out_csv", out])
        seconds[f"eval_cli_{impl}_s"] = time.perf_counter() - t0
        check(rc == 0, f"eval_cli --impl {impl} exit code 0")
        with open(out) as f:
            tables[impl] = {r["track"]: {k: float(r[k]) for k in
                                         ("SDR", "SIR", "SAR", "NSDR")}
                            for r in csv.DictReader(f)}
    check(sorted(tables["torch"]) == sorted(tables["numpy"])
          and len(tables["torch"]) == N_SONGS, "eval_cli scored every song")
    diff = max(abs(tables["torch"][t][k] - v)
               for t, m in tables["numpy"].items() for k, v in m.items())
    vals = [v for m in tables["torch"].values() for v in m.values()]
    print(f"eval: eval_cli --impl torch (f64 on the card) vs --impl numpy, "
          f"{N_SONGS} songs of {SONG_SECONDS} s: max |d| {diff:.3e} dB "
          f"(bound 1e-9); fallbacks {bss_torch.fallbacks - before}; "
          f"song0 {json.dumps(tables['torch']['0000_song0'])}")
    check(diff <= 1e-9 and all(math.isfinite(v) for v in vals),
          "eval_cli on the card equals the numpy reference within 1e-9 dB")
    check(bss_torch.fallbacks == before, "eval_cli: no BSS call fell back")

    cfg = get_config("default")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).to("cuda")
    spec = os.path.join(work, "spec")
    # one song: the scan phase's fits ran validation_sdr on all three on
    # the card; the host's BSS takes 2.6 s a song
    out = {}
    for impl in ("torch", "numpy"):
        t0 = time.perf_counter()
        out[impl] = validation_sdr(model, spec, cfg, impl=impl, max_songs=1,
                                   device="cuda")
        seconds[f"validation_sdr_{impl}_s"] = time.perf_counter() - t0
    d = max(abs(out["torch"][k] - out["numpy"][k])
            for k in ("SDR", "SIR", "SAR", "NSDR"))
    print(f"eval: validation_sdr of 1 song on the card, BSS on the card vs "
          f"the host: max |d| {d:.3e} dB; seconds {json.dumps(seconds)}")
    check(d <= 1e-9 and len(out["torch"]["per_song"]) == 1
          and not out["torch"]["skipped"],
          "validation_sdr: the song scored, card BSS equals the host's")
    check(bss_torch.fallbacks == before, "validation_sdr: no fallback")
    return seconds


# the layout programs' checks (layout_programs, layout_fit_programs): the
# rows of a global batch's ragged tail and of a padded batch's real rows
LAYOUT_TAIL_B = 20
LAYOUT_PADDED_B = 24


def _host_batches(np, spec: str, b: int, n: int, seed: int, frames=128):
    """``n`` global host batches of ``b`` patches of ``frames`` frames from
    the slice's spectra."""
    from svs_torch.data.dataset import PatchDataset

    ds = PatchDataset(spec, samples_per_song=64, input_len=frames)
    return [{k: np.asarray(v) for k, v in batch.items()}
            for batch in ds.batches(b, seed=seed, n_steps=n)]


def layout_programs(torch, np, label: str, kind: str, mesh, cfg, hosts,
                    evals, counts: dict) -> dict:
    """Layout ``kind``'s train step over ``mesh`` as its cached program
    (``train/graphs.py``) against its eager body (``step.eager``), each
    from the state of seed 0 with a dropout generator of seed 1, over the
    global host batches ``hosts`` (``(batch, pad_rows_to)``, cut as ``fit``
    cuts them: ``dryrun.layout_batch``): the metrics of every call and the
    full state after the last (parameters, BN, Adam's moments) the same
    bits; its eval program (captured when it is built) against the eager
    eval on each of ``evals`` (``(batch, rows)``), the same bits; the
    replay's and the eager body's ms by CUDA events; a traced replay's
    busy ms, idle share and loss-kernel launches; the first call's (the
    eager warm-up) and the second's (the capture and a replay) seconds;
    each program's bytes.  The loss kernels' launches of the program
    calls, read as the step graph phase reads them (the wrappers' counts
    zeroed just before and read just after, the replays' from a
    torch.profiler trace of the calls less the wrappers' eager launches),
    are added into ``counts``."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.parallel import dryrun
    from svs_torch.train import graphs

    dev = mesh[0] if isinstance(mesh, tuple) else mesh.device  # PP's pair
    graphs.CACHE.clear()
    eager_state, step = dryrun.layout_state(kind, cfg, mesh, 0)
    prog_state, _ = dryrun.layout_state(kind, cfg, mesh, 0)
    body = step.eager
    ge, gp = (torch.Generator(dev).manual_seed(1) for _ in range(2))
    calls = [dryrun.layout_batch(kind, mesh, h, pad) for h, pad in hosts]
    secs, got = [], []

    def program_calls():
        for batch in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(step(prog_state, batch, gp)[1])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)

    cdm.reset_counts()
    cfl.reset_counts()
    wants = [body(eager_state, batch, ge)[1] for batch in calls]
    body_n = list(_loss_counts()[0])
    cdm.reset_counts()
    cfl.reset_counts()
    seen = {}
    # device_events takes a trace again if it held no device time: the
    # calls run once
    for key, _, n in device_events(
            torch, lambda: None if secs else program_calls()):
        if _kernel_of(key) in LOSS_NAMES:
            seen[_kernel_of(key)] = seen.get(_kernel_of(key), 0) + n
    prog_n, rec = _loss_counts()
    rep_n = tuple(seen.get(k, 0) - g for k, g in zip(LOSS_NAMES, prog_n))
    m_diff = max(_max_diff(torch, [g[k] for k in w], list(w.values()))
                 for g, w in zip(got, wants))
    full_e, full_p = dryrun._full(eager_state), dryrun._full(prog_state)
    s_diff = max(dryrun._max_diff(full_e[k], full_p[k])
                 for k in ("sd", "mu", "nu"))
    programs = dryrun.programs(prog_state.model)
    r = dict(metrics_max_diff=m_diff, state_max_diff=s_diff,
             programs=programs, body_launches=body_n,
             warmup_launches=list(prog_n), captured=list(rec),
             replay_launches=list(rep_n),
             warmup_call_s=secs[0], capture_call_s=secs[1])
    check(m_diff == 0.0 and s_diff == 0.0
          and prog_state.step == eager_state.step == len(calls)
          and sorted(programs) == [(1, 1), (1, 2)],
          f"{label}: {len(calls)} program calls give the eager body's bits "
          f"(metrics {m_diff:g}, state {s_diff:g}), a program a signature "
          f"{programs}")
    evaluate = dryrun.layout_eval_step(kind, cfg, mesh)
    e_diff = 0.0
    for host, rows in evals:
        # a program is captured when it is built: its first call replays
        batch = dryrun.layout_val_batch(kind, mesh, host, rows)
        out = evaluate(prog_state, batch)
        want = evaluate.eager(eager_state, batch)
        e_diff = max(e_diff, _max_diff(torch, [out[k] for k in want],
                                       list(want.values())))
    check(e_diff == 0.0, f"{label}: eval programs give the eager eval's "
          "bits")
    r["eval_max_diff"] = e_diff
    r["replay_ms"] = cuda_ms(torch, lambda: step(prog_state, calls[0], gp),
                             reps=10, warmup=1)
    r["eager_ms"] = cuda_ms(torch, lambda: body(eager_state, calls[0], ge),
                            reps=3, warmup=1)
    traced = {}
    busy = device_breakdown(
        torch, lambda: step(prog_state, calls[0], gp), f"{label} replay",
        (("loss_kernels", ("spec::",)),) + FAMILIES, kernels=traced)
    # a host-fed call (PP's numpy batches) holds pageable copies that the
    # trace's busy time and the events' window do not cover alike (shares
    # from -0.32 to 0.38 read on the H100): no idle share there
    host_fed = not all(isinstance(v, torch.Tensor)
                       for v in calls[0].values())
    r.update(replay_busy_ms=busy, replay_idle_share=None if host_fed
             else 1.0 - busy / r["replay_ms"],
             replay_trace_launches=[traced.get(k, 0) for k in LOSS_NAMES])
    r["program_bytes"] = {
        f"{'train' if hasattr(p, 'captures') else 'eval'} B="
        f"{tuple(p.input.values())[0].shape[0]}": p.nbytes
        for p in graphs.CACHE.programs_of(prog_state.model)}
    print(f"{label}: {len(calls)} program calls against the eager body: "
          f"metrics max diff {m_diff:g}, state (parameters, BN, Adam) "
          f"{s_diff:g}, eval {e_diff:g}; programs (captures, replays) "
          f"{programs}; loss kernel launches (spectral_mag fwd/bwd, "
          f"loss_partials fwd/bwd): eager body {body_n}, the programs' "
          f"warm-up steps {list(prog_n)}, captured {list(rec)}, replays "
          f"{list(rep_n)} (a traced replay's {r['replay_trace_launches']}); "
          f"step ms replay {r['replay_ms']:.3f}, eager body "
          f"{r['eager_ms']:.3f} (CUDA events); a traced replay busy "
          f"{busy:.3f} ms, idle share "
          + ("not measured (host-fed)" if host_fed
             else f"{r['replay_idle_share']:.3f}") + "; first "
          f"call {secs[0]:.3f} s, second (capture) {secs[1]:.3f} s; "
          f"program bytes {r['program_bytes']}")
    per = LOSS_PER_STEP[cfg.mr_mag_impl]
    n_prog = len(programs)
    replays = len(calls) - n_prog
    # a trace of the calls may lack a replay's kernel records (ROADMAP
    # C.7): it must hold whole replays, at least one and at most all
    seen_replays = {n // v for n, v in zip(rep_n, per) if v}
    r["traced_replays"] = (seen_replays.pop() if len(seen_replays) == 1
                           and all(n % v == 0 for n, v in zip(rep_n, per)
                                   if v) else None)
    if any(per) and r["traced_replays"] != replays:
        print(f"{label}: the trace of the calls held {r['traced_replays']} "
              f"of the {replays} replays' loss-kernel records")
    check(tuple(body_n) == tuple(len(calls) * v for v in per)
          and prog_n == tuple(n_prog * v for v in per)
          and rec == tuple(n_prog * v for v in per)
          and (not any(per) or (r["traced_replays"] is not None
                                and 0 < r["traced_replays"] <= replays))
          and tuple(r["replay_trace_launches"]) == per,
          f"{label}: loss-kernel launches of the eager body {body_n}, the "
          f"warm-up steps {prog_n}, captured {rec}, replays {rep_n} (of "
          f"{replays} replays)")
    for i, name in enumerate(LOSS_NAMES):
        c = counts.setdefault(name, {"eager": 0, "captured": 0,
                                     "replayed": 0})
        c["eager"] += prog_n[i]
        c["captured"] += rec[i]
        c["replayed"] += rep_n[i]
    del eager_state, prog_state, step, body
    graphs.CACHE.clear()
    return r


def layout_fit_programs(torch, np, label: str, work: str, mesh, cfg,
                        **layout) -> dict:
    """Two epochs of ``fit(mesh=mesh, **layout)`` with validation (the
    ``default`` preset, B = 32, ``SCAN_SAMPLES`` patches a song: 3 full
    steps and a ragged tail an epoch), its steps as the layout's programs,
    against the same fit with the eager bodies: the text log, the metrics
    (but the epochs' seconds) and the final state (parameters, BN, Adam's
    moments) the same bits; the epoch seconds of each."""
    from svs_torch.parallel import dryrun
    from svs_torch.train import graphs, loop

    spec = os.path.join(work, "spec")
    root = os.path.join(work, f"layout_fit_{label.replace(' ', '_')}")
    cfg = dataclasses.replace(cfg, samples_per_song=SCAN_SAMPLES)
    dev = mesh[0] if isinstance(mesh, tuple) else mesh.device  # PP's pair

    def opts(run_name):
        return loop.TrainOptions(
            train_folder=spec, valid_folder=spec, label="x", epoch=2,
            batch_size=TRAIN_B, load_path="none",
            ckpt_dir=os.path.join(root, run_name, "CKPT"),
            log_dir=os.path.join(root, run_name, "LOG"), progress=False,
            val_interval=1, device=str(dev), mesh=mesh, **layout)

    t0 = time.perf_counter()
    out, builds = {}, {}
    for name in ("eager", "programs"):
        graphs.CACHE.clear()
        before = graphs.CACHE.builds
        state, _, _ = _recording_fit(torch, opts(name), cfg,
                                     eager=name == "eager")
        builds[name] = graphs.CACHE.builds - before
        out[name] = (state.step, dryrun._full(state), [
            {k: v for k, v in json.loads(x).items() if k != "secs"}
            for x in _read_lines(os.path.join(root, name, "LOG",
                                              "metrics_x.jsonl"))],
            _read_lines(os.path.join(root, name, "LOG", "log_x.txt")))
        del state
    graphs.CACHE.clear()
    (s_e, f_e, m_e, l_e), (s_p, f_p, m_p, l_p) = out["eager"], out[
        "programs"]
    diff = max(dryrun._max_diff(f_e[k], f_p[k]) for k in ("sd", "mu", "nu"))
    secs = {k: [json.loads(x)["secs"] for x in _read_lines(
        os.path.join(root, k, "LOG", "metrics_x.jsonl")) if '"secs"' in x]
        for k in out}
    steps = 2 * -(-N_SONGS * SCAN_SAMPLES // TRAIN_B)
    same = l_e == l_p and m_e == m_p
    print(f"{label} fit: 2 epochs of {steps // 2} steps (a tail of "
          f"{N_SONGS * SCAN_SAMPLES % TRAIN_B}) with validation: programs "
          f"({builds['programs']} built) against the eager bodies (built "
          f"{builds['eager']}): log and metrics the same {same}, final "
          f"state max diff {diff:g}; epoch seconds "
          f"programs {secs['programs']}, eager {secs['eager']} "
          f"({time.perf_counter() - t0:.1f} s for both)")
    check(s_e == s_p == steps and same and diff == 0.0
          and builds["eager"] == 0 and builds["programs"] >= 3,
          f"{label} fit: the program fit is the eager fit, bit for bit")
    return dict(same_bits=True, epoch_s=secs, programs_built=builds[
        "programs"])


def layout_hosts(np, spec: str, frames: int = 128, b: int = TRAIN_B):
    """The layout checks' global host batches as ``fit`` hands them to a
    step: two full batches, a batch of ``LAYOUT_PADDED_B`` real rows
    padded to ``b`` with a 0 ``weight``, then a ragged tail of
    ``LAYOUT_TAIL_B`` rows twice (CP, whose batch is not cut by rows: its
    padded batch carries the 0 ``weight``); and the eval batches: a full
    one and the tail padded to ``b``."""
    full = _host_batches(np, spec, b, 4, 21, frames)
    tail = {k: v[:LAYOUT_TAIL_B] for k, v in full[3].items()}
    padded = {k: v[:LAYOUT_PADDED_B] for k, v in full[2].items()}
    hosts = [(full[0], None), (full[1], None), (padded, b), (tail, None),
             (tail, None)]
    return hosts, [(full[1], b), (tail, b)]


def cp_hosts(np, frames: int, b: int):
    """The CP checks' batches (``layout_hosts``' with the padded batch a
    full one whose last row weighs 0, and the tail of its own shape, as
    CP's validation runs the whole batch), random patches of ``frames``
    frames as the cp phase's (the slice's songs are shorter)."""
    full = []
    for seed in (31, 32, 33):
        rng = np.random.default_rng(seed)
        shape = (b, 512, frames)
        full.append({"mix": rng.random(shape, np.float32),
                     "voc": rng.random(shape, np.float32) * 0.5,
                     "mix_angle": (rng.random(shape, np.float32) - 0.5) * 6,
                     "voc_angle": (rng.random(shape, np.float32) - 0.5) * 6})
    weighted = dict(full[2], weight=np.r_[np.ones(b - 1), 0.0].astype(
        np.float32))
    tail = {k: v[:b // 2] for k, v in full[1].items()}
    hosts = [(full[0], None), (full[1], None), (weighted, None),
             (tail, None), (tail, None)]
    return hosts, [(full[1], b), (tail, b // 2)]


def _ms(pair) -> str:
    return " / ".join(f"{v:.3f}" for v in pair)


def program_turns(torch, mesh, cfg, host) -> dict:
    """ms a replay (CUDA events, means of 20 after each program's warm-up
    and capture) of the single step's program on ``host`` (``single``), on
    it with the all-ones ``weight`` that ``shard_batch`` appends
    (``weighted``) and of the world-of-one DP program (``dp``), in turns:
    single, weighted, dp, dp, weighted, single."""
    from svs_torch.parallel import dryrun
    from svs_torch.train import graphs
    from svs_torch.train import step as tstep

    dev = mesh.device
    graphs.CACHE.clear()
    one = tstep.batch_to_device(host, dev)
    weighted = dict(one, weight=torch.ones(len(host["mix"]), device=dev))
    runs = {name: (tstep.create_train_state(0, cfg, device=dev),
                   tstep.make_train_step(cfg), batch)
            for name, batch in (("single", one), ("weighted", weighted))}
    runs["dp"] = (*dryrun.layout_state("dp", cfg, mesh, 0),
                  dryrun.layout_batch("dp", mesh, host))
    gens = {k: torch.Generator(dev).manual_seed(2) for k in runs}
    ms = {}
    for name in ("single", "weighted", "dp", "dp", "weighted", "single"):
        state, step, batch = runs[name]
        gen = gens[name]
        ms.setdefault(name, []).append(cuda_ms(
            torch, lambda: step(state, batch, gen), reps=20, warmup=2))
    del runs
    graphs.CACHE.clear()
    ratio = (sum(ms["dp"]) / sum(ms["single"]) - 1.0,
             sum(ms["dp"]) / sum(ms["weighted"]) - 1.0)
    print(f"dp world 1 program vs the single step's program, "
          f"{cfg.mr_mag_impl}, B={TRAIN_B}, replay ms (CUDA events, means "
          f"of 20 in turns single, weighted, dp, dp, weighted, single): "
          + "; ".join(f"{k} {_ms(v)}" for k, v in ms.items())
          + f"; the DP program {100 * ratio[0]:+.2f} % against the "
          f"unweighted single program, {100 * ratio[1]:+.2f} % against the "
          f"weighted one; {nvidia_smi_line()}")
    return dict(ms, dp_over_single=ratio[0], dp_over_weighted=ratio[1])


def dp_phase(torch, np, spec: str) -> dict:
    """The data-parallel layer on the card; returns the loss kernels'
    launches in the world-of-one DP steps, the backend two ranks on the
    card run over (NCCL, or gloo where NCCL refuses a duplicate GPU), and
    the loss kernels' launches in the DP programs' calls (``eager``,
    ``captured``, ``replayed``, ``layout_programs``')."""
    import torch.distributed as dist

    from svs_torch.data.dataset import PatchDataset
    from svs_torch.infer import graphs as infer_graphs
    from svs_torch.infer import separate
    from svs_torch.models.unet import UNet
    from svs_torch.parallel import dp, dryrun, mesh as mesh_lib
    from svs_torch.parallel.launch import Ranks
    from svs_torch.train import graphs
    from svs_torch.utils.config import get_config

    work = os.path.dirname(spec)
    graph_counts = {}

    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = {k: np.asarray(v) for k, v in
            next(iter(ds.batches(TRAIN_B, seed=11))).items()}
    default = get_config("default")
    line = {"smi": nvidia_smi_line()}

    # a world of one over NCCL (no torchrun environment)
    mesh = mesh_lib.make_mesh()
    check(mesh.size == 1 and mesh.backend == "nccl",
          f"make_mesh alone: a world of one over NCCL ({mesh})")
    total = [0, 0, 0, 0]
    for impl in DP_PER_STEP:
        cfg = dataclasses.replace(default, mr_mag_impl=impl)
        r = dryrun.layout_parity(mesh, cfg, host, ("dp",), time_reps=5)["dp"]
        r["dp_ms"] = [t[0] for t in r["ms"]]
        r["dp_eager_ms"] = [t[0] for t in r["eager_ms"]]
        counts = tuple(r["kernels"])
        check(counts == DP_PER_STEP[impl], f"dp {impl}: loss-kernel launches "
              f"{counts} == {DP_PER_STEP[impl]} in one DP step")
        total = [a + c for a, c in zip(total, counts)]
        print(f"dp world 1 (nccl) {impl}: default preset B={TRAIN_B}, DP step "
              f"program {_ms(r['dp_ms'])} ms, eager body "
              f"{_ms(r['dp_eager_ms'])} ms vs the single step's program "
              f"{_ms(r['ref_ms'])} ms, eager body {_ms(r['ref_eager_ms'])} "
              f"ms (CUDA events, means of 5 steps in turns: single, DP, DP, "
              f"single); loss rel {r['loss_rel']:.2e}, "
              f"grad_norm rel {r['grad_norm_rel']:.2e}, BN {r['bn_abs']:.2e}, "
              f"params max {r['params_max']:.2e} mean {r['params_mean']:.2e}; "
              f"program vs eager body {r['vs_eager']:g}; launches "
              f"{list(counts)}")
        check(r["ok"], f"dp {impl}: the world-of-one DP step within the "
              "dry-run envelope of make_train_step")
        check(all(r[k] == 0.0 for k in ("loss_rel", "grad_norm_rel", "bn_abs",
                                        "params_max")),
              f"dp {impl}: the world-of-one DP step gives make_train_step's "
              "bits")
        check(r["programmed"] and r["vs_eager"] == 0.0,
              f"dp {impl}: the DP program gives its eager body's bits")
        line[f"w1_{impl}"] = r

    # the DP train and eval steps as programs (train/graphs.py) against
    # their eager bodies under the three loss paths, the programmed fit,
    # and the DP program's replay beside the single step program's
    t_graph = time.perf_counter()
    hosts, evals = layout_hosts(np, spec)
    for impl in STEP_IMPLS:
        cfg = dataclasses.replace(default, mr_mag_impl=impl)
        line[f"program_{impl}"] = layout_programs(
            torch, np, f"dp program {impl}", "dp", mesh, cfg, hosts, evals,
            graph_counts)
    line["program_fit"] = layout_fit_programs(
        torch, np, "dp program", work, mesh,
        dataclasses.replace(default, mr_mag_impl="pallas_fused"))
    for impl in DP_PER_STEP:
        line[f"vs_single_{impl}"] = program_turns(
            torch, mesh, dataclasses.replace(default, mr_mag_impl=impl),
            host)
    line["program_s"] = time.perf_counter() - t_graph

    frames = SP_SECONDS * SR // 768 + 1
    mag = np.abs(np.random.default_rng(4).standard_normal(
        (513, frames))).astype(np.float32)
    cfg32 = dataclasses.replace(default, compute_dtype="float32")
    model = UNet(cfg32, generator=torch.Generator().manual_seed(0))
    model = model.to("cuda").eval()
    for mode in ("segments", "overlap"):
        ms = {}
        for name, fn in (
                ("mesh", lambda: separate.separate_magnitude_mesh(
                    model, mag, mesh, mode=mode)),
                ("one", lambda: separate.separate_magnitude(
                    model, mag, mode=mode, device="cuda"))):
            fn()  # warm
            t0 = time.perf_counter()
            out = fn()
            ms[name] = (time.perf_counter() - t0) * 1e3
            ms[name + "_out"] = out
        err = float(np.abs(ms.pop("mesh_out") - ms.pop("one_out")).max())
        print(f"dp world 1 sp {mode}: {SP_SECONDS}-s song ({frames} frames), "
              f"float32, separate_magnitude_mesh {ms['mesh']:.2f} ms vs "
              f"separate_magnitude {ms['one']:.2f} ms (wall, host included); "
              f"max |d| {err:.3e} (bound {SP_ATOL:g})")
        check(err <= SP_ATOL, f"sp {mode}: the mesh decode equals the "
              "unsharded one")
        line[f"sp_{mode}"] = dict(ms, max_abs_err=err)
    # the rank's SP mask as its program (dp.make_sp_separate) against its
    # eager body: the bits (float32, cuDNN deterministic) on the song's
    # block of windows and on sp_parity's, and ms in turns
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        r = dryrun.sp_parity(mesh, model, mag)
        n_seg = -(-frames // cfg32.input_len)
        x = np.pad(mag[1:], ((0, 0), (0, n_seg * cfg32.input_len - frames)))
        segs = np.zeros((-(-n_seg // 8) * 8, 512, cfg32.input_len),
                        np.float32)
        segs[:n_seg] = x.reshape(512, n_seg, -1).transpose(1, 0, 2)
        segs = torch.from_numpy(segs).cuda()
        fn = dp.make_sp_separate(mesh, cfg32)
        block = float((fn(model, segs) - fn.eager(model, segs)).abs().max())
        sp_ms = {}
        for name in ("program", "eager", "eager", "program"):
            run = fn if name == "program" else fn.eager
            sp_ms.setdefault(name, []).append(dryrun._event_ms(
                lambda: run(model, segs), segs.device, 10, warmup=2))
        sp_bytes = [p.nbytes for p in infer_graphs.CACHE.programs_of(model)]
    finally:
        torch.backends.cudnn.deterministic = was
    print(f"dp world 1 sp program: each rank's mask of its windows as the "
          f"cached decode program, against its eager body: max |d| "
          f"{r['vs_eager']:g} on 8 random windows, {block:g} on the "
          f"{SP_SECONDS}-s song's {tuple(segs.shape)} block (float32, cudnn "
          f"deterministic); mask ms program {_ms(sp_ms['program'])}, eager "
          f"{_ms(sp_ms['eager'])} (CUDA events, means of 10 in turns program, "
          f"eager, eager, program); the model's decode programs MB "
          f"{_mb(sp_bytes)}; {nvidia_smi_line()}")
    check(r["programmed"] and r["vs_eager"] == 0.0 and block == 0.0,
          "sp: the SP mask program gives its eager body's bits")
    line["sp_program"] = dict(vs_eager=r["vs_eager"], block_vs_eager=block,
                              ms=sp_ms, program_bytes=sp_bytes,
                              block=list(segs.shape))
    del segs
    infer_graphs.CACHE.clear()
    graphs.CACHE.clear()  # its programs hold the group's collectives
    dist.destroy_process_group()

    # two ranks on the one card: NCCL first, gloo with CUDA tensors if it
    # refuses
    t0 = time.perf_counter()
    try:
        with Ranks(2, device="cuda:0", backend="nccl", timeout=180) as ranks:
            got = ranks.run(dryrun.collective_probe)
    except RuntimeError as e:
        # NCCL's one expected refusal; any other failure fails the phase
        hit = [x.strip() for x in str(e).splitlines()
               if "Duplicate GPU" in x]
        check(bool(hit), "NCCL, two ranks on one card: ran, or refused as "
              f"a duplicate GPU, not: {str(e)[-2000:]}")
        nccl, backend = "refused: " + hit[0][:400], "gloo"
    else:
        check(got == [2.0, 2.0], "NCCL, two ranks on one card: the "
              f"all_reduce of ones gives [2.0, 2.0], not {got}")
        nccl, backend = f"ran, all_reduce of ones gave {got}", "nccl"
    print(f"dp two ranks on one card, NCCL: {nccl} "
          f"({time.perf_counter() - t0:.1f} s); the two-rank step runs "
          f"over {backend}")
    line["nccl_two_ranks_one_card"] = nccl
    with Ranks(2, device="cuda:0", backend=backend, timeout=900) as ranks:
        ranks.run(dryrun.no_tf32)
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(cfg32, mr_mag_impl=impl)
            r = ranks.run(dryrun.layout_parity, cfg, host, ("dp",),
                          time_reps=2)[0]["dp"]
            r["dp_ms"] = [t[0] for t in r["ms"]]
            print(f"dp world 2 ({backend}, one card) {impl}: float32 default "
                  f"preset, B = 2 x {TRAIN_B // 2} against the single-process "
                  f"B={TRAIN_B} step: loss rel {r['loss_rel']:.2e}, "
                  f"grad_norm rel {r['grad_norm_rel']:.2e}, BN "
                  f"{r['bn_abs']:.2e}, params max {r['params_max']:.2e} "
                  f"mean {r['params_mean']:.2e}, "
                  f"rank spread {r['spread']:g}; programmed "
                  f"{r['programmed']} (programs {r['programs']}); DP step "
                  f"{_ms(r['dp_ms'])} ms vs the single step's program "
                  f"{_ms(r['ref_ms'])} ms (CUDA events on rank 0, "
                  f"means of 2 steps in turns); rank 0 launches "
                  f"{r['kernels']}")
            check(tuple(r["kernels"]) == DP_PER_STEP[impl],
                  f"dp world 2 {impl}: the loss kernels launched on rank 0")
            check(r["ok"] and r["spread"] == 0.0,
                  f"dp world 2 {impl}: the single-process step within the "
                  "dry-run envelope, the ranks the same bits")
            check(backend == "nccl" or (not r["programmed"]
                                        and r["programs"] == []),
                  f"dp world 2 {impl}: gloo ranks on the card built no "
                  f"program and ran the eager body ({r['programs']})")
            line[f"w2_{impl}"] = dict(r, backend=backend)
        # the SP decode on the two ranks: each rank's mask a program (its
        # body holds no collective), the all-reduce outside it
        ranks.run(dryrun.deterministic)
        r = ranks.run(dryrun.sp_decode_parity, cfg32, mag)[0]
        print(f"dp world 2 ({backend}, one card) sp: the {SP_SECONDS}-s "
              f"song, float32, against separate_magnitude: max |d| "
              f"segments {r['segments']:.3e}, overlap {r['overlap']:.3e}; "
              f"each rank's mask program against its eager body "
              f"{r['vs_eager']:g} (programmed {r['programmed']})")
        check(r["programmed"] and r["vs_eager"] == 0.0
              and max(r["segments"], r["overlap"]) <= SP_ATOL,
              f"dp world 2 sp: the mask programs give their eager bodies' "
              f"bits on {backend} ranks, the decode the unsharded one")
        line["w2_sp"] = r
    print("dp: " + json.dumps(line))
    return dict(zip(LOSS_NAMES, total)), backend, graph_counts


# dpscan: the mesh epoch_scan at a world of one over NCCL, under the loss
# kernel paths (the scan phase's fit: SCAN_SAMPLES patches a song, 3 full
# steps and a ragged tail an epoch, SCAN_EPOCHS epochs across the drop)
DPSCAN_IMPLS = tuple(DP_PER_STEP)


@contextlib.contextmanager
def forced_collectives():
    """The DP step's collectives run at a world of one: the two checks that
    the step reads, ``mesh.all_sum``'s (bound by name in the modules of the
    model and the losses) and ``dp._sum_over_ranks``', are handed the mesh
    as if it crossed ranks, so each all-reduces over its one rank (an
    exact copy) while the block runs.  The host-flag helpers
    (``mesh.agree``, ``dp.replicate_state``) keep their check: a world of
    one has no gloo group for them.  Yields a one-item list, the count of
    ``torch.distributed.all_reduce`` calls since entry (eager, or recorded
    into a graph)."""
    import torch.distributed as dist

    from svs_torch.parallel import dp
    from svs_torch.parallel import mesh as mesh_lib

    def crossing(fn):
        def run(x, mesh):
            return fn(x, None if mesh is None
                      else dataclasses.replace(mesh, size=2))
        return run

    count = [0]
    reduce = dist.all_reduce

    def counted(*args, **kwargs):
        count[0] += 1
        return reduce(*args, **kwargs)

    # every module of the port that bound all_sum by name
    users = [m for name, m in sorted(sys.modules.items())
             if name.startswith("svs_torch.") and m is not mesh_lib
             and getattr(m, "all_sum", None) is mesh_lib.all_sum]
    check({"svs_torch.models.unet", "svs_torch.losses.mrstft",
           "svs_torch.losses.masked_l1", "svs_torch.ops.cuda.fused_loss"}
          <= {m.__name__ for m in users},
          "forced collectives: the step's all_sum callers found")
    saved = [(m, "all_sum", m.all_sum) for m in users]
    saved += [(dp, "_sum_over_ranks", dp._sum_over_ranks),
              (dist, "all_reduce", reduce)]
    for m in users:
        m.all_sum = crossing(mesh_lib.all_sum)
    dp._sum_over_ranks = crossing(dp._sum_over_ranks)
    dist.all_reduce = counted
    try:
        yield count
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


@contextlib.contextmanager
def weighted_single():
    """The single-device scan's batches carry the all-ones ``weight`` that
    ``mesh.shard_batch`` appends at a world of one (the weighted means
    round otherwise than the unweighted ones): its gathers, in the graph
    body and the dataset's tail, append it while the block runs."""
    import torch

    from svs_torch.data import device_data
    from svs_torch.train import scan

    gather = device_data.gather_crops

    def weighted(planes, songs, starts, input_len):
        out = gather(planes, songs, starts, input_len)
        out["weight"] = torch.ones(len(songs), device=songs.device)
        return out

    device_data.gather_crops = scan.gather_crops = weighted
    try:
        yield
    finally:
        device_data.gather_crops = scan.gather_crops = gather


def _full_state(torch, state) -> list:
    """A state's tensors on the host: parameters, BN buffers, Adam's."""
    from svs_torch.parallel import dp
    return [t.detach().cpu() for t in dp._state_tensors(state)]


def _same_bits(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _nccl_launches(torch, fn) -> int:
    """NCCL's kernels in a torch.profiler trace of ``fn()``."""
    return sum(n for name, _, n in device_events(torch, fn)
               if "nccl" in name.lower())


def dpscan_phase(torch, np, work: str) -> dict:
    """``epoch_scan`` over a data-parallel mesh on the card (see the
    module's docstring); returns, per loss kernel, summed over the mesh
    fits under the kernel paths: the wrappers' eager launches (the graph's
    warm-up step and the tail program's), the calls recorded into a graph
    (the epoch graphs' and the tail program's; each count
    zeroed just before the fit and read just after) and the replays'
    launches (the fit's profiler count less the eager launches)."""
    import torch.distributed as dist

    from svs_torch.data import device_data as dd
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.parallel import dp, dryrun
    from svs_torch.parallel import mesh as mesh_lib
    from svs_torch.parallel.launch import Ranks
    from svs_torch.train import loop
    from svs_torch.train import scan
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    root = os.path.join(work, "dpscan")
    n_full = N_SONGS * SCAN_SAMPLES // TRAIN_B
    n_rep = SCAN_EPOCHS * n_full - 1
    line = {"smi": nvidia_smi_line(), "seconds": {}}
    t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        line["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    def opts(run, **kw):
        return loop.TrainOptions(
            train_folder=spec, valid_folder="none", label="x",
            epoch=SCAN_EPOCHS, batch_size=TRAIN_B, load_path="none",
            ckpt_dir=os.path.join(root, run, "CKPT"),
            log_dir=os.path.join(root, run, "LOG"), progress=False,
            device_data="on", epoch_scan=True, device="cuda", **kw)

    def written(run):
        names = ("LOG/log_x.txt", "CKPT/svs_x.ckpt", "CKPT/svs_x_400.ckpt")
        out = {}
        for name in names:
            with open(os.path.join(root, run, name), "rb") as f:
                out[name] = f.read()
        return out

    def config(impl):
        return dataclasses.replace(get_config("default"), mr_mag_impl=impl,
                                   samples_per_song=SCAN_SAMPLES,
                                   lr_drop_epoch=1)

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = mesh_lib.make_mesh()
    check(mesh.size == 1 and mesh.backend == "nccl",
          f"dpscan: make_mesh alone is a world of one over NCCL ({mesh})")
    counts = {k: [0, 0, 0] for k in LOSS_NAMES}
    try:
        for impl in DPSCAN_IMPLS:
            cfg = config(impl)
            per = DP_PER_STEP[impl]
            # (a) the mesh fit against the single-device fit of the same
            # weighted batches, both graph fits
            with weighted_single():
                single = _recording_fit(torch, opts(f"single_{impl}"), cfg)
            cdm.reset_counts()
            cfl.reset_counts()
            meshed = _recording_fit(torch, opts(f"mesh_{impl}", mesh=mesh),
                                    cfg, trace=True)
            got, rec = _loss_counts()
            epoch, seen = meshed[2]["epoch"], meshed[2]["kernels"]
            # eager: the epoch graph's warm-up step and the first tail
            # (the DP program's warm-up); captured: the graph twice (the
            # learning-rate drop) and the DP program once; replayed: the
            # graph's replays and the second tail's
            want = tuple(2 * v for v in per)
            want_rec = tuple(3 * v for v in per)
            eager_by_kernel = dict(zip(LOSS_NAMES, got))
            eager_by_kernel["adjoint"] = got[1] + got[3]
            rep = {k: n - eager_by_kernel[k] for k, n in seen.items()}
            per_kernel = dict(zip(LOSS_NAMES, per))
            per_kernel["adjoint"] = per[1] + per[3]
            want_rep = {k: (n_rep + 1) * v for k, v in per_kernel.items()
                        if v}
            files = (written(f"single_{impl}"), written(f"mesh_{impl}"))
            same = {k: files[0][k] == files[1][k] for k in files[0]}
            bits = _same_bits(torch, _full_state(torch, single[0]),
                              _full_state(torch, meshed[0]))
            print(f"dpscan {impl} (a): world of one over NCCL, fit "
                  f"{SCAN_EPOCHS} epochs of {n_full} replays and a tail, "
                  f"B={TRAIN_B}: captures {epoch.captures}, replays "
                  f"{epoch.replays}; files equal to the single-device "
                  f"graph fit's {json.dumps(same)}, final state the same "
                  f"bits {bits}; wrapper launches {list(got)} (want "
                  f"{list(want)}), captured {list(rec)} (want "
                  f"{list(want_rec)}); the replays' {json.dumps(rep)} "
                  f"(want {json.dumps(want_rep)})")
            check(epoch.captures == 2 and epoch.replays == n_rep,
                  f"dpscan {impl}: captured twice, {n_rep} replays")
            check(got == want and rec == want_rec and rep == want_rep,
                  f"dpscan {impl}: the loss kernels launched, captured and "
                  "replayed inside the mesh graph fit")
            check(all(same.values()) and bits,
                  f"dpscan {impl}: the world-of-one mesh fit writes the "
                  "single-device graph fit's files and bits")
            for i, name in enumerate(LOSS_NAMES):
                counts[name][0] += got[i]
                counts[name][1] += rec[i]
                counts[name][2] += rep.get(name, 0)
            line[f"a_{impl}"] = dict(same, state=bits)
            del single, meshed, epoch
            lap(f"a_{impl}")

            # (b) one world-of-one epoch with the collectives forced on
            # (the first collectives of the group: the warm-up step makes
            # NCCL's communicator), against the same epochs without them
            host = PatchDataset(spec, samples_per_song=SCAN_SAMPLES,
                                input_len=cfg.input_len)
            ds = dd.DeviceDataset(host, mesh=mesh)
            songs, starts, _ = dd.epoch_index_arrays(host, TRAIN_B,
                                                     shuffle=True, seed=5)
            adam = tstep.make_optimizer(cfg)

            def fresh():
                return (tstep.create_train_state(0, cfg, adam, device="cuda"),
                        torch.Generator("cuda").manual_seed(3))

            def runner(fn, state, gen):
                def run():
                    return fn(state, ds.planes, songs, starts, gen)[1]
                return run

            plain_fn = scan.make_epoch_scan(cfg, mesh=mesh)
            s_p, g_p = fresh()
            l_p = [runner(plain_fn, s_p, g_p)() for _ in range(2)]
            # the single-device epochs without the weight, for scale
            single_fn = scan.make_epoch_scan(cfg)
            s_s, g_s = fresh()
            l_s = torch.cat([runner(single_fn, s_s, g_s)()
                             for _ in range(2)]).cpu()
            rel = float(((l_s - torch.cat(l_p).cpu()).abs()
                         / torch.cat(l_p).cpu().abs()).max())
            pmax, pmean, _ = _param_envelope(torch, s_s, s_p,
                                             cfg.learning_rate)
            print(f"dpscan {impl}: the single-device epochs without the "
                  f"weight against the mesh epochs: step losses max rel "
                  f"{rel:.3e}, parameters max |d| {pmax:.3e} (lr "
                  f"{cfg.learning_rate:g}), mean {pmean:.3e}")
            line[f"unweighted_{impl}"] = dict(loss_rel=rel, params_max=pmax,
                                              params_mean=pmean)
            with forced_collectives() as calls:
                forced_fn = scan.make_epoch_scan(cfg, mesh=mesh)
                s_f, g_f = fresh()
                l_f = [runner(forced_fn, s_f, g_f)()]
                torch.cuda.synchronize()
                first = calls[0]
                # the second epoch, replays only, traced (the profiler may
                # retake it: only the first epoch's bits are compared then)
                replayed = _nccl_launches(
                    torch, lambda: l_f.append(runner(forced_fn, s_f,
                                                     g_f)()))
                check(forced_fn.replays == 2 * n_full - 1,
                      f"dpscan {impl} (b): one trace of {n_full} replays")
                second = calls[0] - first
                # one eager forced DP step: its all-reduce calls and NCCL
                # kernels
                s_e, g_e = fresh()
                batch = mesh_lib.shard_batch(mesh, ds.gather(songs[0],
                                                             starts[0]))
                step = dp.make_dp_train_step(mesh, cfg)
                before = calls[0]
                eager = _nccl_launches(torch, lambda: step(s_e, batch, g_e))
                n_calls = calls[0] - before
            bits = (_same_bits(torch, [torch.cat(l_p).cpu()],
                               [torch.cat(l_f).cpu()])
                    and _same_bits(torch, _full_state(torch, s_p),
                                   _full_state(torch, s_f)))
            print(f"dpscan {impl} (b): collectives forced on at a world of "
                  f"one: all_reduce calls {first} in the first epoch (the "
                  f"warm-up step and the capture, want 2 x {n_calls}), "
                  f"{second} in the replayed epoch (want 0); NCCL kernels: "
                  f"{eager} in one eager step, {replayed} in {n_full} "
                  f"replays (want {eager * n_full}); losses and state the "
                  f"unforced epochs' bits {bits}")
            check(n_calls > 0 and first == 2 * n_calls and second == 0,
                  f"dpscan {impl} (b): the graph holds the step's "
                  f"{n_calls} all-reduces, called from the host once")
            check(replayed == eager * n_full, f"dpscan {impl} (b): the "
                  "replays launch the eager step's NCCL kernels")
            check(bits, f"dpscan {impl} (b): forced collectives give the "
                  "same bits")
            line[f"b_{impl}"] = dict(all_reduces_a_step=n_calls,
                                     nccl_kernels_a_step=eager,
                                     nccl_kernels_replayed=replayed,
                                     replays=n_full, bits=bits)
            lap(f"b_{impl}")

            # (d) ms a graph step, in turns: the single-device graph,
            # that graph on the weighted batches, the mesh graph, the
            # forced-collective mesh graph
            with weighted_single():
                weighted_fn = scan.make_epoch_scan(cfg)
                s_w, g_w = fresh()
                runner(weighted_fn, s_w, g_w)()  # its capture
            fns = {"single": runner(single_fn, s_s, g_s),
                   "weighted": runner(weighted_fn, s_w, g_w),
                   "mesh": runner(plain_fn, s_p, g_p),
                   "forced": runner(forced_fn, s_f, g_f)}
            ms = {k: [] for k in fns}
            with forced_collectives():
                for k in ("single", "weighted", "mesh", "forced", "forced",
                          "mesh", "weighted", "single"):
                    ms[k].append(cuda_ms(torch, fns[k], reps=3, warmup=1)
                                 / n_full)
            print(f"dpscan {impl} (d): ms a graph step (CUDA events, "
                  f"B={TRAIN_B}, in turns): single-device "
                  f"{_ms(ms['single'])}, single-device on the weighted "
                  f"batches {_ms(ms['weighted'])}, mesh {_ms(ms['mesh'])}, "
                  f"forced collectives {_ms(ms['forced'])}; {line['smi']}")
            line[f"d_{impl}"] = ms
            del ds, s_p, s_f, s_e, s_s, s_w, fns
            lap(f"d_{impl}")
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = was

    # (c) two gloo ranks on the one card: refused before any step
    gloo = dict(train_folder=spec, valid_folder="none", label="g", epoch=1,
                batch_size=TRAIN_B, load_path="none",
                ckpt_dir=os.path.join(root, "gloo", "CKPT"),
                log_dir=os.path.join(root, "gloo", "LOG"), progress=False,
                device_data="on", device="cuda")
    with Ranks(2, device="cuda:0", backend="gloo", timeout=300) as ranks:
        got = ranks.run(dryrun.scan_refusal, gloo, config("pallas_fused"))
    print(f"dpscan (c): two gloo ranks on one card, fit(epoch_scan=True): "
          f"{json.dumps(got)}")
    check(all(r["refused"] and "cannot capture gloo's" in r["refused"]
              and not r["made_dirs"] and r["bytes"] == 0 for r in got),
          "dpscan (c): both gloo ranks refused before any step")
    line["c"] = got
    lap("c")
    print("dpscan: " + json.dumps(line))
    return {k: dict(zip(("eager", "captured", "replayed"), v))
            for k, v in counts.items()}


def _mb(values) -> str:
    return " / ".join(f"{v / 1e6:.3f}" for v in values)


def zero_phase(torch, np, spec: str, backend: str) -> dict:
    """ZeRO-1 and FSDP on the card (``svs_torch.parallel.zero``, through
    ``dryrun.layout_parity``): a world of one over NCCL at the ``default``
    preset, B = 32, under ``pallas_fused`` and ``pallas_bf16`` (each
    sharded step ``make_train_step``'s bits, the loss kernels launched
    inside it at ``DP_PER_STEP``'s counts), then two ranks on the card over
    ``backend`` (dp_phase's: gloo where NCCL refused a duplicate GPU),
    float32, 2 x 16 (each sharded step the DP step's bits, each rank's
    resting state within ``ZERO_MB_RTOL`` of ``ZERO_MB``).  cuDNN's
    deterministic algorithms throughout, TF32 off.  At the world of one
    the ZeRO-1 and FSDP train and eval steps as programs against their
    eager bodies under the three loss paths (``layout_programs``) and a
    programmed ``fit`` of each (``layout_fit_programs``); the gloo ranks
    build no program.  Returns the loss kernels' launches in the
    world-of-one sharded steps, and in the programs' calls."""
    import torch.distributed as dist

    from svs_torch.data.dataset import PatchDataset
    from svs_torch.parallel import dryrun, mesh as mesh_lib
    from svs_torch.parallel.launch import Ranks
    from svs_torch.train import graphs
    from svs_torch.utils.config import get_config

    work = os.path.dirname(spec)
    graph_counts = {}
    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = {k: np.asarray(v) for k, v in
            next(iter(ds.batches(TRAIN_B, seed=11))).items()}
    default = get_config("default")
    line = {"smi": nvidia_smi_line()}
    total = [0, 0, 0, 0]
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = mesh_lib.make_mesh()
        check(mesh.size == 1 and mesh.backend == "nccl",
              f"make_mesh alone: a world of one over NCCL ({mesh})")
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(default, mr_mag_impl=impl)
            r = dryrun.layout_parity(mesh, cfg, host, time_reps=5)
            for kind in ("zero1", "fsdp"):
                x = r[kind]
                counts = tuple(x["kernels"])
                check(counts == DP_PER_STEP[impl], f"zero {kind} {impl}: "
                      f"loss-kernel launches {counts} == "
                      f"{DP_PER_STEP[impl]} in one step")
                total = [a + c for a, c in zip(total, counts)]
                check(all(x[k] == 0.0 for k in ("loss_rel", "grad_norm_rel",
                                                "bn_abs", "params_max"))
                      and x["vs_dp"] == 0.0 and x["shards_ok"]
                      and x["programmed"] and x["vs_eager"] == 0.0,
                      f"zero {kind} {impl}: the world-of-one step gives "
                      "make_train_step's bits (metrics, parameters, BN, "
                      "Adam's moments), its program its eager body's")
            print(f"zero world 1 (nccl) {impl}: default preset B={TRAIN_B}, "
                  "the same bits as make_train_step and the DP step, each "
                  "program its eager body's; ms, program / eager body "
                  "(CUDA events, means of 5 steps in turns single, DP, "
                  "ZeRO-1, FSDP, FSDP, ZeRO-1, DP, single; cudnn "
                  f"deterministic): single {_ms(r['dp']['ref_ms'])} / "
                  f"{_ms(r['dp']['ref_eager_ms'])}; "
                  + "; ".join(f"{k} {_ms([t[0] for t in r[k]['ms']])} / "
                              f"{_ms([t[0] for t in r[k]['eager_ms']])}"
                              for k in dryrun.LAYOUTS)
                  + "; peak MB " + ", ".join(
                      f"{k} {_mb(r[k]['peak'])}" for k in dryrun.LAYOUTS)
                  + "; launches " + ", ".join(
                      f"{k} {r[k]['kernels']}" for k in dryrun.LAYOUTS))
            line[f"w1_{impl}"] = r
        # the ZeRO-1 and FSDP train and eval steps as programs against
        # their eager bodies, and a programmed fit of each
        t_graph = time.perf_counter()
        hosts, evals = layout_hosts(np, spec)
        for kind in ("zero1", "fsdp"):
            for impl in STEP_IMPLS:
                cfg = dataclasses.replace(default, mr_mag_impl=impl)
                line[f"program_{kind}_{impl}"] = layout_programs(
                    torch, np, f"zero {kind} program {impl}", kind, mesh,
                    cfg, hosts, evals, graph_counts)
            line[f"program_fit_{kind}"] = layout_fit_programs(
                torch, np, f"zero {kind} program", work, mesh,
                dataclasses.replace(default, mr_mag_impl="pallas_fused"),
                **{kind: True})
        line["program_s"] = time.perf_counter() - t_graph
        graphs.CACHE.clear()
        dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = was

    cfg32 = dataclasses.replace(default, compute_dtype="float32")
    with Ranks(2, device="cuda:0", backend=backend, timeout=900) as ranks:
        ranks.run(dryrun.no_tf32)
        ranks.run(dryrun.deterministic)
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(cfg32, mr_mag_impl=impl)
            r = ranks.run(dryrun.layout_parity, cfg, host, time_reps=2)[0]
            print(f"zero world 2 ({backend}, one card) {impl}: float32 "
                  f"default preset, B = 2 x {TRAIN_B // 2}: vs DP "
                  + ", ".join(f"{k} {r[k]['vs_dp']:g}"
                              for k in ("zero1", "fsdp"))
                  + "; spread " + ", ".join(f"{k} {r[k]['spread']:g}"
                                            for k in dryrun.LAYOUTS)
                  + "; resting MB a rank " + ", ".join(
                      f"{k} {_mb(r[k]['bytes'])}" for k in dryrun.LAYOUTS)
                  + "; peak MB a rank " + ", ".join(
                      f"{k} {_mb(r[k]['peak'])}" for k in dryrun.LAYOUTS)
                  + f"; ms a step, ranks 0 / 1 (CUDA events, means of 2 "
                  f"steps in turns; {backend}'s and the host's time, not "
                  f"checked): single B={TRAIN_B} {_ms(r['dp']['ref_ms'])}; "
                  + "; ".join(
                      f"{k} " + ", ".join(_ms(t) for t in r[k]["ms"])
                      for k in dryrun.LAYOUTS)
                  + f"; envelope vs the single B={TRAIN_B} step: params "
                  "max " + ", ".join(f"{k} {r[k]['params_max']:.2e}"
                                     for k in dryrun.LAYOUTS))
            for kind in ("zero1", "fsdp"):
                x = r[kind]
                check(x["vs_dp"] == 0.0 and x["spread"] == 0.0
                      and x["shards_ok"] and x["ok"],
                      f"zero world 2 {kind} {impl}: the DP two-rank step's "
                      "bits, the ranks' gathered states the same, each "
                      "leaf the channel rule's slice")
            for kind in dryrun.LAYOUTS:
                check(backend == "nccl" or (not r[kind]["programmed"]
                                            and r[kind]["programs"] == []),
                      f"zero world 2 {kind} {impl}: gloo ranks on the card "
                      "built no program and ran the eager body")
            for kind in dryrun.LAYOUTS:
                want = ZERO_MB[kind] * 1e6
                check(all(abs(b - want) <= ZERO_MB_RTOL * want
                          for b in r[kind]["bytes"]),
                      f"zero world 2 {kind}: resting bytes a rank "
                      f"{r[kind]['bytes']} within {ZERO_MB_RTOL:g} of "
                      f"{want:g}")
            line[f"w2_{impl}"] = dict(r, backend=backend)
    print("zero: " + json.dumps(line))
    return dict(zip(LOSS_NAMES, total)), graph_counts


def tp_phase(torch, np, spec: str, backend: str) -> dict:
    """Tensor parallelism on the card (``svs_torch.parallel.tp``, through
    ``dryrun.layout_parity`` beside DP on the same ranks): a (1, 1) mesh, a
    world of one over NCCL, at the ``default`` preset, B = 32, under
    ``pallas_fused`` and ``pallas_bf16`` (the TP step ``make_train_step``'s
    bits, the loss kernels launched inside it at ``DP_PER_STEP``'s counts),
    then the (1, 2) and (2, 2) meshes over ``backend`` (dp_phase's: gloo
    where NCCL refused a duplicate GPU) with every rank on the one card,
    float32 (the TP step within the dry run's envelope of the
    single-process step, the ranks' gathered states the same bits, each
    rank's resting state within ``ZERO_MB_RTOL`` of ``TP_BYTES``).  cuDNN's
    deterministic algorithms throughout, TF32 off.  At the (1, 1) mesh the
    TP train and eval steps as programs against their eager bodies under
    the three loss paths and a programmed ``fit``; the gloo ranks build no
    program.  Returns the loss kernels' launches in the world-of-one TP
    steps, and in the programs' calls."""
    import torch.distributed as dist

    from svs_torch.data.dataset import PatchDataset
    from svs_torch.parallel import dryrun, mesh as mesh_lib
    from svs_torch.parallel.launch import Ranks
    from svs_torch.train import graphs
    from svs_torch.utils.config import get_config

    work = os.path.dirname(spec)
    graph_counts = {}
    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = {k: np.asarray(v) for k, v in
            next(iter(ds.batches(TRAIN_B, seed=11))).items()}
    default = get_config("default")
    line = {"smi": nvidia_smi_line()}
    total = [0, 0, 0, 0]
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = mesh_lib.make_2d_mesh(1, 1)
        check(mesh.shape == {"data": 1, "model": 1}
              and mesh.backend == "nccl",
              f"make_2d_mesh(1, 1): a world of one over NCCL ({mesh})")
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(default, mr_mag_impl=impl)
            r = dryrun.layout_parity(mesh, cfg, host, ("dp", "tp"),
                                     time_reps=5)
            x = r["tp"]
            counts = tuple(x["kernels"])
            check(counts == DP_PER_STEP[impl], f"tp {impl}: loss-kernel "
                  f"launches {counts} == {DP_PER_STEP[impl]} in one step")
            total = [a + c for a, c in zip(total, counts)]
            check(all(x[k] == 0.0 for k in ("loss_rel", "grad_norm_rel",
                                            "bn_abs", "params_max"))
                  and x["vs_dp"] == 0.0 and x["shards_ok"]
                  and x["programmed"] and x["vs_eager"] == 0.0,
                  f"tp {impl}: the (1, 1) step gives make_train_step's "
                  "bits (metrics, parameters, BN, Adam's moments), its "
                  "program its eager body's")
            print(f"tp (1, 1) (nccl) {impl}: default preset B={TRAIN_B}, "
                  "the same bits as make_train_step and the DP step, each "
                  "program its eager body's; ms, program / eager body "
                  "(CUDA events, means of 5 steps in turns single, DP, TP, "
                  "TP, DP, single; cudnn deterministic): single "
                  f"{_ms(r['dp']['ref_ms'])} / "
                  f"{_ms(r['dp']['ref_eager_ms'])}; "
                  + "; ".join(f"{k} {_ms([t[0] for t in r[k]['ms']])} / "
                              f"{_ms([t[0] for t in r[k]['eager_ms']])}"
                              for k in ("dp", "tp"))
                  + "; peak MB " + ", ".join(
                      f"{k} {_mb(r[k]['peak'])}" for k in ("dp", "tp"))
                  + f"; launches {list(counts)}")
            line[f"w1_{impl}"] = r
        # the TP train and eval steps as programs against their eager
        # bodies, and a programmed fit
        t_graph = time.perf_counter()
        hosts, evals = layout_hosts(np, spec)
        for impl in STEP_IMPLS:
            cfg = dataclasses.replace(default, mr_mag_impl=impl)
            line[f"program_{impl}"] = layout_programs(
                torch, np, f"tp program {impl}", "tp", mesh, cfg, hosts,
                evals, graph_counts)
        line["program_fit"] = layout_fit_programs(
            torch, np, "tp program", work, mesh,
            dataclasses.replace(default, mr_mag_impl="pallas_fused"),
            parallel="tp")
        line["program_s"] = time.perf_counter() - t_graph
        graphs.CACHE.clear()
        dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = was

    cfg32 = dataclasses.replace(default, compute_dtype="float32")
    for shape in TP_MESHES:
        n = shape[0] * shape[1]
        with Ranks(n, device="cuda:0", backend=backend,
                   timeout=900) as ranks:
            ranks.run(dryrun.no_tf32)
            ranks.run(dryrun.deterministic)
            for impl in DP_PER_STEP:
                cfg = dataclasses.replace(cfg32, mr_mag_impl=impl)
                r = ranks.run(dryrun.tp_parity, shape, cfg, host,
                              time_reps=1)[0]
                x = r["tp"]
                print(f"tp {shape} ({backend}, one card) {impl}: float32 "
                      f"default preset, B = {shape[0]} x "
                      f"{TRAIN_B // shape[0]} rows, channels cut "
                      f"{shape[1]} ways, against the single-process "
                      f"B={TRAIN_B} step: loss rel {x['loss_rel']:.2e}, "
                      f"grad_norm rel {x['grad_norm_rel']:.2e}, BN "
                      f"{x['bn_abs']:.2e}, params max {x['params_max']:.2e} "
                      f"mean {x['params_mean']:.2e}, rank spread "
                      f"{x['spread']:g}; enc4 weight held {x['enc4'][0]}; "
                      f"resting MB a rank tp {_mb(x['bytes'])}, dp "
                      f"{_mb(r['dp']['bytes'])}; peak MB a rank tp "
                      f"{_mb(x['peak'])}, dp {_mb(r['dp']['peak'])}; ms a "
                      f"step by rank (CUDA events, one step each in "
                      f"turns; {backend}'s and the host's time, not "
                      f"checked): single B={TRAIN_B} "
                      f"{_ms(r['dp']['ref_ms'])}; "
                      + "; ".join(f"{k} " + ", ".join(_ms(t) for t in
                                                      r[k]["ms"])
                                  for k in ("dp", "tp"))
                      + f"; rank 0 launches {x['kernels']}")
                check(tuple(x["kernels"]) == DP_PER_STEP[impl],
                      f"tp {shape} {impl}: the loss kernels launched on "
                      "rank 0")
                check(x["ok"] and x["spread"] == 0.0 and x["shards_ok"]
                      and x["enc4"][0][0] == 128 // shape[1],
                      f"tp {shape} {impl}: the single-process step within "
                      "the dry-run envelope, the ranks' gathered states "
                      "the same, each leaf the channel rule's slice")
                check(all(abs(b - TP_BYTES) <= ZERO_MB_RTOL * TP_BYTES
                          for b in x["bytes"]),
                      f"tp {shape}: resting bytes a rank {x['bytes']} "
                      f"within {ZERO_MB_RTOL:g} of {TP_BYTES}")
                check(backend == "nccl" or all(
                    not r[k]["programmed"] and r[k]["programs"] == []
                    for k in ("dp", "tp")), f"tp {shape} {impl}: gloo ranks "
                    "on the card built no program and ran the eager body")
                line[f"{shape[0]}x{shape[1]}_{impl}"] = dict(r,
                                                             backend=backend)
    print("tp: " + json.dumps(line))
    return dict(zip(LOSS_NAMES, total)), graph_counts


def pp_phase(torch, np, work: str):
    """Pipeline parallelism on the card with both stages on ``cuda:0`` (see
    the module's docstring), its steps as programs (``pp.programmed``);
    returns the loss kernels' launches inside the PP steps, each step's
    count zeroed just before it and read just after, and in the PP
    programs' calls (``eager``, ``captured``, ``replayed``,
    ``layout_programs``')."""
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.parallel import dryrun, pp
    from svs_torch.train import graphs, loop
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = {k: np.asarray(v) for k, v in
            next(iter(ds.batches(TRAIN_B, seed=11))).items()}
    default = get_config("default")
    cfg32 = dataclasses.replace(default, compute_dtype="float32")
    devs = pp.make_pp_mesh(("cuda:0", "cuda:0"))
    dev = devs[0]
    check(pp.programmed(devs) and not pp.programmed(("cuda:0", "cpu")),
          "pp: programs where both stages are one card, the eager step "
          "over two distinct devices")
    line = {"smi": nvidia_smi_line(), "split": PP_SPLIT,
            "boundary": pp.boundary_shape(default, PP_SPLIT,
                                          TRAIN_B // PP_MICRO, 128)}
    total = [0, 0, 0, 0]
    graph_counts = {}

    def counted(r, what):
        nonlocal total
        total = [a + c for a, c in zip(total, r["kernels"])]
        line[what] = r
        return r

    def programs_ok(r, what, want):
        print(f"pp {what}: program against its eager body over "
              f"{r['calls']} calls: max |d| {r['vs_eager']:g} (metrics, "
              f"parameters, BN, Adam's moments, the generator's state)"
              + (f", against make_train_step's program {r['vs_single']:g}"
                 if "vs_single" in r else "")
              + f"; programs (captures, replays) {r['programs']}")
        check(r["programmed"] and r["vs_eager"] == 0.0
              and r.get("vs_single", 0.0) == 0.0
              and sorted(r["programs"]) == want,
              f"pp {what}: the program gives its eager body's bits"
              + (" and make_train_step's" if "vs_single" in r else ""))

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(default, mr_mag_impl=impl)
            r = counted(dryrun.pp_parity(devs, cfg, host, n_micro=1,
                                         split=PP_SPLIT), f"n1_{impl}")
            print(f"pp n_micro 1 {impl}: default preset B={TRAIN_B}, both "
                  f"stages on {dev}, split {PP_SPLIT}: max |d| against "
                  f"make_train_step {r['bits']:g} (loss {r['total']:.6f} vs "
                  f"{r['ref_total']:.6f}, params max {r['params_max']:.2e}); "
                  f"launches {r['kernels']}; stage bytes {r['stage_bytes']}")
            check(tuple(r["kernels"]) == DP_PER_STEP[impl],
                  f"pp {impl}: loss-kernel launches {r['kernels']} == "
                  f"{DP_PER_STEP[impl]} inside the PP step")
            check(r["ok"] and r["bits"] == 0.0, f"pp {impl}: the "
                  "one-microbatch PP step gives make_train_step's bits")
            programs_ok(r, f"n_micro 1 {impl}", [(1, 2)])
        ragged = pp.pad_batch({k: v[:PP_REAL_ROWS] for k, v in host.items()},
                              TRAIN_B)
        for what, impl, batch in (("n4", "pallas_fused", host),
                                  ("n4_ragged", "pallas_bf16", ragged)):
            cfg = dataclasses.replace(cfg32, mr_mag_impl=impl)
            r = counted(dryrun.pp_parity(devs, cfg, batch, n_micro=PP_MICRO,
                                         split=PP_SPLIT), what)
            live = -(-int(batch.get("weight", np.ones(TRAIN_B)).sum())
                     // (TRAIN_B // PP_MICRO))
            print(f"pp {what} {impl}: float32 default preset, B={TRAIN_B} in "
                  f"{PP_MICRO} microbatches ({live} live) against the "
                  f"microbatch oracle: loss {r['total']:.6f} vs "
                  f"{r['ref_total']:.6f} (rel {r['loss_rel']:.2e}), BN "
                  f"{r['bn_abs']:.2e}, grad_norm rel "
                  f"{r['grad_norm_rel']:.2e}, params max "
                  f"{r['params_max']:.2e} mean {r['params_mean']:.2e}; "
                  f"launches {r['kernels']}")
            check(math.isfinite(r["total"]) and r["ok"]
                  and r["loss_rel"] == 0.0 and r["bn_abs"] == 0.0,
                  f"pp {what}: the oracle's loss and BN statistics, the "
                  "step within the dry-run envelope")
            check(tuple(r["kernels"]) == tuple(
                c * live for c in DP_PER_STEP[impl]),
                f"pp {what}: the loss kernels launched once a live "
                "microbatch")
            programs_ok(r, f"{what} {impl}", [(1, 2)])

        # the programs under the three loss paths at one microbatch (a
        # step's loss-kernel launches are the single step's), the batches
        # as fit hands them (each padded to B rows), against the eager
        # bodies; then the four-microbatch program, full and ragged,
        # dropout on
        t_graph = time.perf_counter()
        hosts, evals = layout_hosts(np, spec)
        hosts = [(h, TRAIN_B) for h, _ in hosts]
        for impl in STEP_IMPLS:
            cfg = dataclasses.replace(default, mr_mag_impl=impl)
            line[f"program_{impl}"] = layout_programs(
                torch, np, f"pp program n_micro 1 {impl}", "pp", devs, cfg,
                hosts, evals, graph_counts)
        cfg = dataclasses.replace(default, mr_mag_impl="pallas_fused")
        r = dryrun.pp_program_parity(
            devs, cfg, [dryrun.layout_batch("pp", devs, h, pad)
                        for h, pad in hosts], n_micro=PP_MICRO,
            split=PP_SPLIT)
        programs_ok(r, f"n_micro {PP_MICRO} pallas_fused, dropout "
                    f"{cfg.dropout_rate}, full and ragged batches",
                    [(1, 1), (1, 2)])
        line["program_n4"] = r
        line["program_s"] = time.perf_counter() - t_graph

        # ms and memory in turns: the single step's program, the PP
        # programs and the PP eager steps (both stages on one card, so no
        # overlap)
        batch = tstep.batch_to_device(host, dev)
        runs = {"single": (tstep.create_train_state(0, cfg, device=dev),
                           tstep.make_train_step(cfg))}
        for n in (1, PP_MICRO):
            step = pp.make_pp_train_step(devs, cfg, n_micro=n,
                                         split=PP_SPLIT)
            for name, run in ((f"pp{n}", step), (f"pp{n}_eager", step.eager)):
                runs[name] = (pp.shard_state(tstep.create_train_state(
                    0, cfg, device=dev), devs, split=PP_SPLIT), run)
        order = ("single", "pp1", "pp1_eager", f"pp{PP_MICRO}",
                 f"pp{PP_MICRO}_eager")
        ms, peak = {}, {}
        for name in order + order[::-1]:
            state, step = runs[name]
            gen = torch.Generator(dev).manual_seed(2)
            # a program's warm-up step and its capture; an eager step's
            # first call
            for _ in range(1 if name.endswith("eager") else 2):
                step(state, batch, gen)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            ms.setdefault(name, []).append(dryrun._event_ms(
                lambda: step(state, batch, gen), dev, PP_REPS))
            peak[name] = torch.cuda.max_memory_allocated(dev)
        traced, busy = {}, {}
        for name in ("pp1", f"pp{PP_MICRO}"):
            state, step = runs[name]
            gen = torch.Generator(dev).manual_seed(3)
            kernels = {}
            busy[name] = device_breakdown(
                torch, lambda: step(state, batch, gen), f"{name} replay",
                (("loss_kernels", ("spec::",)),) + FAMILIES, kernels=kernels)
            traced[name] = [kernels.get(k, 0) for k in LOSS_NAMES]
        resting = pp.stage_bytes(runs["pp1"][0])
        nbytes = {name: sum(p.nbytes for p in graphs.CACHE.programs_of(
            runs[name][0].model)) for name in ("single", "pp1",
                                               f"pp{PP_MICRO}")}
        del runs
        graphs.CACHE.clear()
        print(f"pp ms a step, default preset B={TRAIN_B} pallas_fused, cudnn "
              f"deterministic (CUDA events, means of {PP_REPS} steps in "
              f"turns {', '.join(order + order[::-1])}; the programs' "
              "replays after a warm-up step and a capture; both stages on "
              "one card, so no overlap): " + "; ".join(
                  f"{k} {_ms(v)}" for k, v in ms.items())
              + "; peak MB on the card over the steps " + ", ".join(
                  f"{k} {v / 1e6:.1f}" for k, v in peak.items())
              + f"; program MB {_mb(nbytes.values())} ({list(nbytes)}); "
              f"a traced replay's busy ms {busy}, loss-kernel launches "
              f"{traced}; resting MB a stage {_mb(resting)}; "
              f"{nvidia_smi_line()}")
        line.update(ms=ms, peak=peak, stage_bytes=resting,
                    program_bytes=nbytes, replay_busy_ms=busy,
                    replay_trace_launches=traced)
        check(all(math.isfinite(t) and t > 0 for v in ms.values() for t in v),
              "pp: finite step times")
        check(traced["pp1"] == list(LOSS_PER_STEP["pallas_fused"])
              and traced[f"pp{PP_MICRO}"] == [
                  PP_MICRO * c for c in LOSS_PER_STEP["pallas_fused"]],
              f"pp: a traced replay launches the loss kernels once a live "
              f"microbatch ({traced})")
    finally:
        torch.backends.cudnn.deterministic = was

    # fit under PP for an epoch, then the single-device fit resumes from
    # its checkpoint
    out = os.path.join(work, "pp_fit")
    cfg = dataclasses.replace(default, samples_per_song=FIT_SAMPLES)

    def opts(label, **kw):
        return loop.TrainOptions(
            train_folder=spec, valid_folder=spec, label=label,
            batch_size=TRAIN_B, val_interval=1, progress=False,
            ckpt_dir=os.path.join(out, "CKPT"),
            log_dir=os.path.join(out, "LOG"), device="cuda", **kw)

    steps = -(-N_SONGS * FIT_SAMPLES // TRAIN_B)
    t0 = time.perf_counter()
    state = loop.fit(opts("pp", epoch=1, load_path=os.path.join(out, "none"),
                          mesh=devs, parallel="pp", pp_micro=PP_MICRO,
                          pp_split=PP_SPLIT), cfg)
    fit_s = time.perf_counter() - t0
    check(isinstance(state, pp.PPState) and state.step == steps,
          f"pp fit: {steps} PP steps in the epoch")
    del state
    graphs.CACHE.clear()
    ckpt = os.path.join(out, "CKPT", "svs_pp.ckpt")
    resumed = loop.fit(opts("pp", epoch=2, load_path=ckpt), cfg)
    log = _read_lines(os.path.join(out, "LOG", "log_pp.txt"))
    print(f"pp fit: one epoch of fit(parallel='pp') ({steps} steps, "
          f"{fit_s:.1f} s with validation), then the single-device fit "
          f"resumed from its .ckpt; log {json.dumps(log)}")
    check(type(resumed) is tstep.TrainState and resumed.step == 2 * steps
          and len(log) == 4 and all(math.isfinite(float(x.split()[-1]))
                                    for x in log),
          "pp fit: a .ckpt that the single-device fit resumes")
    line["fit_s"] = fit_s
    del resumed
    graphs.CACHE.clear()
    # the programmed PP fit against the eager one, bit for bit
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        line["program_fit"] = layout_fit_programs(
            torch, np, "pp program", work, devs,
            dataclasses.replace(default, mr_mag_impl="pallas_fused"),
            parallel="pp", pp_micro=PP_MICRO, pp_split=PP_SPLIT)
    finally:
        torch.backends.cudnn.deterministic = was
    print("pp: " + json.dumps(line))
    return dict(zip(LOSS_NAMES, total)), graph_counts


def cp_phase(torch, np, work: str, backend: str) -> dict:
    """Context parallelism on the card (see the module's docstring); returns
    the loss kernels' launches inside the world-of-one CP steps, each
    step's count zeroed just before it and read just after, and in the CP
    programs' calls."""
    import torch.distributed as dist

    from svs_torch.cli import train_cli
    from svs_torch.parallel import dryrun, mesh as mesh_lib
    from svs_torch.parallel import halo
    from svs_torch.parallel.launch import Ranks
    from svs_torch.train import graphs
    from svs_torch.train import loop
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    fine = get_config("fine_tune")
    batch = dryrun.dry_batch(CP_B, fine.input_len)
    default = get_config("default")
    cfg32 = dataclasses.replace(default, compute_dtype="float32")
    mag = np.random.default_rng(6).random((513, CP_FRAMES), np.float32)
    line = {"smi": nvidia_smi_line(), "seconds": {}}
    total = [0, 0, 0, 0]
    graph_counts = {}
    t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        line["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    def step_line(what, r):
        return (f"{what}: loss rel {r['loss_rel']:.2e}, grad_norm rel "
                f"{r['grad_norm_rel']:.2e}, BN {r['bn_abs']:.2e}, params max "
                f"{r['params_max']:.2e} mean {r['params_mean']:.2e}, max |d| "
                f"against make_train_step {r['bits']:g} ("
                + ("the same bits" if r["bits"] == 0.0 else "not the same "
                   "bits") + f"), rank spread {r['spread']:g}; peak MB a rank "
                f"{_mb(r['peak'])}; rank 0 launches {r['kernels']}")

    def decode_line(what, r):
        return (f"{what}: max |d| against separate_magnitude(mode='whole') "
                f"{r['max_abs_err']:.3e}, against the unsharded forward of "
                f"the song padded as CP pads it {r['padded_err']:.3e} (bound "
                f"{CP_ATOL:g}); ms a decode "
                f"by rank (CUDA events, mean of {CP_REPS}, host copies "
                f"included) {_ms(r['ms'])} vs unsharded {r['ref_ms']:.3f}; "
                f"peak MB a rank {_mb(r['peak'])} vs unsharded "
                f"{r['ref_peak'] / 1e6:.3f}; the time-sharded mask "
                f"{'a program' if r['programmed'] else 'eager (the rule)'}, "
                f"against its eager body {r['vs_eager']:g}, ms by rank "
                f"{_ms(r['mask_ms'])} vs eager {_ms(r['mask_eager_ms'])}")

    mesh = mesh_lib.make_mesh()
    check(mesh.size == 1 and mesh.backend == "nccl",
          f"make_mesh alone: a world of one over NCCL ({mesh})")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(fine, mr_mag_impl=impl)
            r = dryrun.cp_parity(mesh, cfg, batch)
            print(step_line(f"cp world 1 (nccl) {impl}, fine_tune B={CP_B} "
                            f"x {fine.input_len} frames, bf16, remat", r))
            check(tuple(r["kernels"]) == DP_PER_STEP[impl],
                  f"cp {impl}: loss-kernel launches {r['kernels']} == "
                  f"{DP_PER_STEP[impl]} inside the CP step")
            check(r["ok"], f"cp {impl}: the world-of-one CP step within the "
                  "dry-run envelope of make_train_step")
            check(r["programmed"] and r["programs"] == [(0, 0)],
                  f"cp {impl}: the CP step a program (its first call the "
                  "eager warm-up step)")
            total = [a + c for a, c in zip(total, r["kernels"])]
            line[f"w1_{impl}"] = r
        # ms a step in turns: single, CP, CP, single, each as its program
        # (after its warm-up and capture)
        cfg = dataclasses.replace(fine, mr_mag_impl="pallas_fused")
        dev = mesh.device
        whole = tstep.batch_to_device(batch, dev)
        whole["weight"] = torch.ones(CP_B, device=dev)
        runs = {"single": (tstep.create_train_state(0, cfg, device=dev),
                           tstep.make_train_step(cfg), whole),
                "cp": (tstep.create_train_state(0, cfg, device=dev),
                       halo.make_cp_train_step(mesh, cfg),
                       halo.shard_batch_time(mesh, batch))}
        gens = {k: torch.Generator(dev).manual_seed(2) for k in runs}
        ms = {}
        for name in ("single", "cp", "cp", "single"):
            state, step, inp = runs[name]
            gen = gens[name]
            ms.setdefault(name, []).append(dryrun._event_ms(
                lambda: step(state, inp, gen), dev, CP_REPS, warmup=2))
        del runs
        print(f"cp world 1 ms a step, fine_tune B={CP_B} pallas_fused, cudnn "
              f"deterministic, the programs' replays (CUDA events, means of "
              f"{CP_REPS} steps in turns single, cp, cp, single): "
              + "; ".join(f"{k} {_ms(v)}" for k, v in ms.items())
              + f"; {nvidia_smi_line()}")
        line["w1_ms"] = ms
        graphs.CACHE.clear()
        lap("w1_steps")
        # the CP train step as its program against its eager body under
        # the three loss paths (its validation is the single eval step's
        # program on the whole batch)
        hosts, evals = cp_hosts(np, fine.input_len, CP_B)
        for impl in STEP_IMPLS:
            cfg = dataclasses.replace(fine, mr_mag_impl=impl)
            line[f"program_{impl}"] = layout_programs(
                torch, np, f"cp program {impl} (fine_tune B={CP_B} x "
                f"{fine.input_len} frames)", "cp", mesh, cfg, hosts, evals,
                graph_counts)
        lap("programs")
    finally:
        torch.backends.cudnn.deterministic = was

    def decodes(n, run):
        """The CP decode over ``n`` ranks of the CP_FRAMES song, which both
        decodes pad alike, and of the 240-s song, which CP pads to 64 n
        frames and separate_magnitude to 1024: held against the unsharded
        forward at CP's padding (svs_tpu's whole-song mesh decode), the
        other difference printed."""
        where = "" if n == 1 else f" ({backend}, one card)"
        r = run(mag)
        print(decode_line(f"cp world {n}{where} decode, {CP_FRAMES}-frame "
                          "song, float32 default preset", r))
        check(max(r["max_abs_err"], r["padded_err"]) <= CP_ATOL,
              f"cp world {n} decode: the whole-song CP decode equals the "
              "unsharded one")
        check(r["programmed"] == (n == 1 or backend == "nccl")
              and (r["vs_eager"] == 0.0 or not r["programmed"]),
              f"cp world {n} decode: a program where the rule takes one "
              "(NCCL or a world of one), its eager body's bits")
        line[f"w{n}_decode"] = r
        r = run(mag[:, :four])
        print(decode_line(f"cp world {n}{where} decode, {four}-frame (240-s) "
                          f"song, CP padding it to {four} frames and the "
                          f"unsharded decode to {-(-four // 1024) * 1024}",
                          r))
        check(r["padded_err"] <= CP_ATOL, f"cp world {n} decode of the 240-s "
              "song: the unsharded forward at CP's padding")
        line[f"w{n}_decode_240s"] = r

    four = SP_SECONDS * SR // 768
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        decodes(1, lambda m: dryrun.cp_decode_parity(mesh, cfg32, m,
                                                     reps=CP_REPS))
    finally:
        torch.backends.cudnn.deterministic = was
    lap("w1_decode")

    # one epoch of fit under CP (the dataset on the card, time-sharded),
    # then the single-device fit resumes from its checkpoint
    out = os.path.join(work, "cp_fit")
    cfg = dataclasses.replace(default, samples_per_song=FIT_SAMPLES)

    def opts(label, **kw):
        return loop.TrainOptions(
            train_folder=spec, valid_folder=spec, label=label,
            batch_size=TRAIN_B, val_interval=1, progress=False,
            ckpt_dir=os.path.join(out, "CKPT"),
            log_dir=os.path.join(out, "LOG"), device="cuda", **kw)

    steps = -(-N_SONGS * FIT_SAMPLES // TRAIN_B)
    t0 = time.perf_counter()
    state = loop.fit(opts("cp", epoch=1, load_path=os.path.join(out, "none"),
                          mesh=mesh, parallel="cp"), cfg)
    fit_s = time.perf_counter() - t0
    check(state.step == steps, f"cp fit: {steps} CP steps in the epoch")
    del state
    line["program_fit"] = layout_fit_programs(
        torch, np, "cp program", work, mesh,
        dataclasses.replace(default, mr_mag_impl="pallas_fused"),
        parallel="cp")
    graphs.CACHE.clear()
    dist.destroy_process_group()
    ckpt = os.path.join(out, "CKPT", "svs_cp.ckpt")
    resumed = loop.fit(opts("cp", epoch=2, load_path=ckpt), cfg)
    log = _read_lines(os.path.join(out, "LOG", "log_cp.txt"))
    print(f"cp fit: one epoch of fit(parallel='cp') ({steps} steps, "
          f"{fit_s:.1f} s with validation), then the single-device fit "
          f"resumed from its .ckpt; log {json.dumps(log)}")
    check(resumed.step == 2 * steps and len(log) == 4
          and all(math.isfinite(float(x.split()[-1])) for x in log),
          "cp fit: a .ckpt that the single-device fit resumes")
    line["fit_s"] = fit_s
    lap("fit")

    # ranks sharing the card over dp's backend, float32, TF32 off
    fine32 = dataclasses.replace(fine, compute_dtype="float32")
    with Ranks(max(n for n, _ in CP_RANKS), device="cuda:0",
               backend=backend, timeout=600) as ranks:
        ranks.run(dryrun.no_tf32)
        lap("pool")
        for n, impl in CP_RANKS:
            cfg = dataclasses.replace(fine32, mr_mag_impl=impl)
            r = ranks.run(dryrun.cp_parity, cfg, batch, first=n)[0]
            print(step_line(
                f"cp world {n} ({backend}, one card) {impl}, float32 "
                f"fine_tune B={CP_B} x {fine.input_len} frames, "
                f"{fine.input_len // n} a rank, against the single-process "
                "step", r))
            check(tuple(r["kernels"]) == DP_PER_STEP[impl],
                  f"cp world {n} {impl}: the loss kernels launched on rank 0")
            check(r["ok"] and r["spread"] == 0.0,
                  f"cp world {n} {impl}: the single-process step within the "
                  "dry-run envelope, the ranks the same bits")
            check(backend == "nccl" or (not r["programmed"]
                                        and r["programs"] == []),
                  f"cp world {n} {impl}: gloo ranks on the card built no "
                  "program and ran the eager body")
            line[f"w{n}_{impl}"] = r
            if n == 2:
                decodes(n, lambda m: ranks.run(
                    dryrun.cp_decode_parity, cfg32, m, reps=CP_REPS,
                    first=n)[0])
            lap(f"w{n}")

    # svs_tpu's refusal: --cp with --dp exits 2
    try:
        with contextlib.redirect_stderr(io.StringIO()) as err:
            train_cli.main(["--label", "x", "--cp", "--dp"])
        code = 0
    except SystemExit as e:
        code = e.code
    print(f"cp: train_cli --cp --dp exits {code}: "
          f"{err.getvalue().strip().splitlines()[-1]}")
    check(code == 2, "train_cli --cp --dp exits 2")
    print("cp: " + json.dumps(line))
    return dict(zip(LOSS_NAMES, total)), graph_counts


def mh_phase(torch, np, work: str) -> dict:
    """Multi-host training on the card (see the module's docstring): one
    pool of MH_HOSTS hosts of one rank each; returns the loss kernels'
    launches inside rank 0's two-host steps, each step's count zeroed
    just before it and read just after."""
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.parallel import dryrun
    from svs_torch.parallel.launch import Ranks
    from svs_torch.utils.config import get_config

    spec = os.path.join(work, "spec")
    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    host = {k: np.asarray(v) for k, v in
            next(iter(ds.batches(TRAIN_B, seed=11))).items()}
    default = get_config("default")
    cfg32 = dataclasses.replace(default, compute_dtype="float32")
    line = {"smi": nvidia_smi_line(), "seconds": {}, "peak_mb": {}}
    total = [0, 0, 0, 0]
    t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        line["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    with Ranks(MH_HOSTS, device="cuda:0", backend="gloo", hosts=MH_HOSTS,
               timeout=600) as ranks:
        ranks.run(dryrun.no_tf32)
        ranks.run(dryrun.deterministic)
        lap("pool")
        for impl in DP_PER_STEP:
            cfg = dataclasses.replace(cfg32, mr_mag_impl=impl)
            r = ranks.run(dryrun.mh_parity, cfg, host)[0]
            print(f"mh {MH_HOSTS} hosts x 1 rank (gloo, one card) {impl}: "
                  f"float32 default preset, B = {TRAIN_B}, host rows "
                  f"{r['rows']} padded to {r['pad_to']}, against "
                  f"make_train_step of the host-major batch: loss rel "
                  f"{r['loss_rel']:.2e}, grad_norm rel "
                  f"{r['grad_norm_rel']:.2e}, BN {r['bn_abs']:.2e}, params "
                  f"max {r['params_max']:.2e} mean {r['params_mean']:.2e}, "
                  f"max |d| {r['bits']:g}, rank spread {r['spread']:g}; "
                  f"peak MB a rank {_mb(r['peak'])}; rank 0 launches "
                  f"{r['kernels']}")
            check(tuple(r["kernels"]) == DP_PER_STEP[impl],
                  f"mh {impl}: the loss kernels launched inside rank 0's "
                  "two-host step")
            check(r["ok"] and r["spread"] == 0.0,
                  f"mh {impl}: the two-host step within the dry-run "
                  "envelope of make_train_step, the ranks the same bits")
            total = [a + c for a, c in zip(total, r["kernels"])]
            line[f"step_{impl}"] = r
            line["peak_mb"][impl] = [v / 1e6 for v in r["peak"]]
        lap("steps")

        data_cfg = dataclasses.replace(default, samples_per_song=MH_SAMPLES)
        for n_steps in (None, 2):
            got = ranks.run(dryrun.mh_data_parity, spec, data_cfg,
                            MH_LOCAL_BS, n_steps=n_steps)
            print(f"mh data, {'wrapped' if n_steps else 'epoch'}: "
                  "MultiHostDeviceDataset against global_batch_from_local "
                  "of the host pipeline, by host: " + "; ".join(
                      f"host {h}: {g['songs']} songs, rows {g['rows']}, "
                      f"equal {g['equal']}" for h, g in enumerate(got)))
            check(all(g["equal"] for g in got) and [g["songs"] for g in got]
                  == [2, 1], "mh data: the device blocks are the host "
                  "pipeline's bits on every host")
            line[f"data_{'wrapped' if n_steps else 'epoch'}"] = got
        aug = {k: v[:MH_AUG_ROWS].copy() for k, v in host.items()}
        for v in aug.values():
            v[MH_AUG_REAL:] = 0.0
        got = ranks.run(dryrun.mh_augment_parity, aug, MH_AUG_REAL,
                        hosts=1)
        print("mh apply_sharded on the card, one host's two shards of "
              f"{MH_AUG_ROWS // 2} rows, {MH_AUG_REAL} real, against the "
              "numpy oracle: " + "; ".join(
                  f"shard {i}: " + json.dumps(g) for i, g in enumerate(got)))
        check(all(max(g["max_err"].values()) <= MH_AUG_TOL and g["in_step"]
                  and g["pads_zero"] and g["untouched"] for g in got),
              "mh apply_sharded: each shard the oracle's rows, the pads "
              "zero, the generators in step")
        line["augment"] = got
        lap("data")

        out = os.path.join(work, "mh_fit")
        cfg = dataclasses.replace(default, samples_per_song=FIT_SAMPLES,
                                  mr_mag_impl="pallas_fused")

        def opts(label, **kw):
            return dict(train_folder=spec, valid_folder=spec, label=label,
                        batch_size=TRAIN_B, val_interval=1, progress=False,
                        ckpt_dir=os.path.join(out, "CKPT"),
                        log_dir=os.path.join(out, "LOG"),
                        load_path=os.path.join(out, "none"), **kw)

        steps = -(-N_SONGS * FIT_SAMPLES // TRAIN_B)
        fits = {}
        for feed in ("on", "off"):
            fits[feed] = ranks.run(dryrun.mh_fit, opts(f"mh_{feed}", epoch=1,
                                                       device_data=feed),
                                   cfg)
            log = _read_lines(os.path.join(out, "LOG", f"log_mh_{feed}.txt"))
            print(f"mh fit, device_data {feed}: by host "
                  f"{json.dumps(fits[feed])}; rank 0's log {json.dumps(log)}")
            check([r["steps"] for r in fits[feed]] == [steps] * MH_HOSTS,
                  f"mh fit {feed}: {steps} steps on every host")
            check(len({r["digest"] for r in fits[feed]}) == 1,
                  f"mh fit {feed}: the hosts hold the same bits")
            check(len(log) == 2 and log[1].startswith("Val ")
                  and all(math.isfinite(float(x.split()[-1])) for x in log),
                  f"mh fit {feed}: one writer, one line an epoch and a "
                  "validation")
        check(fits["on"][0]["digest"] == fits["off"][0]["digest"],
              "mh fit: the songs on the card give the host pipeline's bits")
        lap("fit")
        ckpt = os.path.join(out, "CKPT", "svs_mh_off.ckpt")
        resumed = ranks.run(dryrun.mh_fit, opts("mh_off", epoch=2), cfg,
                            load_paths=[ckpt, os.path.join(out, "none")])
        print(f"mh resume, host 1 without the checkpoint: by host "
              f"{json.dumps(resumed)}")
        check([r["steps"] for r in resumed] == [2 * steps] * MH_HOSTS
              and len({r["digest"] for r in resumed}) == 1,
              "mh resume: sync_resume gives host 1 host 0's state, the "
              "hosts the same bits after")
        line["fit"] = {"steps": steps, "resumed": resumed}
        lap("resume")
    print("mh: " + json.dumps(line))
    return dict(zip(LOSS_NAMES, total))


def step_parity_phase(torch, np, host_batch) -> None:
    """One float32 fft step (B = 4, no dropout) on the card, TF32 off,
    against the same weights and batch on the CPU."""
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    cfg = dataclasses.replace(get_config("default"), compute_dtype="float32",
                              mr_mag_impl="fft", dropout_rate=0.0)
    batch = {k: v[:4] for k, v in host_batch.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        state = tstep.create_train_state(0, cfg, device=dev)
        state, m = tstep.make_train_step(cfg)(
            state, tstep.batch_to_device(batch, dev))
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()})
    (cm, csd), (gm, gsd) = out["cpu"], out["cuda"]
    loss = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30)
               for k in ("l1", "mr", "total"))
    gn = abs(gm["grad_norm"] - cm["grad_norm"]) / cm["grad_norm"]
    bn = max((gsd[k] - csd[k]).abs().max().item() for k in csd
             if "running" in k)
    params = [(gsd[k] - csd[k]).abs() for k in csd
              if "running" not in k and "num_batches" not in k]
    pmax = max(d.max().item() for d in params)
    pmean = (sum(d.sum().item() for d in params)
             / sum(d.numel() for d in params))
    print(f"parity: default-width float32 fft train step, B=4, card (TF32 "
          f"off) vs CPU: loss rel {loss:.3e} (bound {STEP_LOSS_RTOL:g}), "
          f"grad_norm rel {gn:.3e} ({STEP_GN_RTOL:g}), BN stats "
          f"{bn:.3e} ({STEP_BN_ATOL:g}), params max {pmax:.3e} (2.1 lr) "
          f"mean {pmean:.3e} (2e-4); total {gm['total']:.6f} vs "
          f"{cm['total']:.6f}")
    check(loss <= STEP_LOSS_RTOL and gn <= STEP_GN_RTOL
          and bn < STEP_BN_ATOL and pmax <= 2.1 * cfg.learning_rate
          and pmean < 2e-4, "float32 train step on the card matches the CPU")


def slice_phase(torch, np, work: str):
    """The main path through the CLIs; returns the kernels' launch counts."""
    from svs_torch.cli import data_cli, infer_cli
    from svs_torch.data import wav
    from svs_torch.infer import separate
    from svs_torch.models import torch_import
    from svs_torch.models.unet import UNet, param_count
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.utils.config import get_config

    songs, spec = os.path.join(work, "songs"), os.path.join(work, "spec")
    masked, out = os.path.join(work, "masked"), os.path.join(work, "wav")
    write_songs(np, wav, songs, seed=1)
    cfg = get_config("default")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    pth = os.path.join(work, "default_seed0.pth")
    torch_import.save_pth(pth, model)
    print(f"slice: {N_SONGS} songs x {SONG_SECONDS} s at {SR} Hz; default "
          f"preset, {param_count(model)} params, {cfg.compute_dtype}")

    cdsp.reset_counts()
    stages = {}
    t0 = time.perf_counter()
    rc = data_cli.main(["--src", songs, "--tar", spec, "--device", "cuda"])
    stages["to_spec_s"] = time.perf_counter() - t0
    check(rc == 0, "data_cli to_spec exit code 0")
    t0 = time.perf_counter()
    rc = infer_cli.main(["--model_path", pth, "--tar", masked,
                         "--mixture_folder", os.path.join(spec, "mixture"),
                         "--preset", "default", "--mode", "segments",
                         "--device", "cuda"])
    stages["inference_s"] = time.perf_counter() - t0
    check(rc == 0, "infer_cli exit code 0")
    t0 = time.perf_counter()
    rc = data_cli.main(["--src", masked, "--tar", out, "--phase", spec,
                        "--direction", "to_wave", "--device", "cuda"])
    stages["to_wave_s"] = time.perf_counter() - t0
    check(rc == 0, "data_cli to_wave exit code 0")
    launches = {"stft_magphase": cdsp.launches}
    routes = {r: getattr(cdsp, f"{r}_launches")
              for r in ("fft", "mixed", "gemm")}
    print("slice stages: " + json.dumps(stages))
    print("slice launches: " + json.dumps(launches) + ", by route "
          + json.dumps(routes))
    check(launches["stft_magphase"] == 2 * N_SONGS,
          f"stft_magphase launched twice per song (mixture and vocals): "
          f"{launches['stft_magphase']} for {N_SONGS} songs")
    check(routes == {"fft": 2 * N_SONGS, "mixed": 0, "gemm": 0},
          "to_spec went through the fft route only")

    n_frames = 1 + SONG_SECONDS * SR // cfg.hop_size
    for i in range(N_SONGS):
        base = f"{i:04d}_song{i}"
        for folder in ("mixture", "vocal"):
            mag = np.load(os.path.join(spec, folder, f"{base}_spec.npy"))
            ph = np.load(os.path.join(spec, folder, f"{base}_phase.npy"))
            check(mag.shape == ph.shape == (513, n_frames)
                  and np.isfinite(mag).all() and np.isfinite(ph).all(),
                  f"{folder}/{base} spectra: shape (513, {n_frames}), finite")
        m = np.load(os.path.join(masked, f"{base}_spec.npy"))
        check(m.shape == (513, n_frames) and np.isfinite(m).all()
              and (m[0] == 0).all(),
              f"masked {base}: shape, finite, DC row zero")
        y, sr = wav.read_wav(os.path.join(out, f"{base}.wav"))
        check(sr == SR and len(y) == cfg.hop_size * (n_frames - 1)
              and np.isfinite(y).all() and 0 < np.abs(y).max() <= 0.9 + 1e-4,
              f"wav {base}: length, finite, peak 0.9")

    # infer_cli's bf16 masks of song0 on the card against the same .pth and
    # spectrum on the CPU (the DC row is zero on both sides)
    mix0 = np.load(os.path.join(spec, "mixture", "0000_song0_spec.npy"))
    got = np.load(os.path.join(masked, "0000_song0_spec.npy"))
    want = separate.separate_magnitude(
        infer_cli.load_model(pth, cfg, "cpu"), mix0, device="cpu")
    err = np.abs(got[1:] - want[1:]) / np.maximum(mix0[1:], 1e-30)
    print(f"slice: infer_cli bf16 masks of song0, cuDNN vs CPU: "
          f"max_abs_diff mask={err.max():.3e} median={np.median(err):.3e} "
          f"(bounds {UNET_BF16_MAX:g}, {UNET_BF16_MEDIAN:g})")
    check(err.max() < UNET_BF16_MAX and np.median(err) < UNET_BF16_MEDIAN,
          "U-Net bf16 on the card matches the CPU")

    # the kernel's spectra against the torch.fft front end on one song
    from svs_torch.data import prep
    y_mix, _ = wav.load_audio(os.path.join(songs, "song0", "mixture.wav"))
    km, kp = prep.stft_magphase(y_mix, 1024, 768, impl="kernel",
                                device="cuda")
    fm, fp = prep.stft_magphase(y_mix, 1024, 768, impl="fft", device="cuda")
    e = float(np.abs(km * kp - fm * fp).max())
    print(f"slice: kernel front end vs torch.fft front end, song0: "
          f"max_abs_err mag*phase={e:.3e}")
    check(e < ATOL, "kernel front end agrees with the torch.fft front end")

    # separate_wav (the in-process wav -> wav decode), per song
    model = model.cuda().eval()
    rng = np.random.default_rng(2)
    per_song = {}
    for seconds in (SONG_SECONDS, 4 * 60):
        y = (rng.standard_normal(seconds * SR) * 0.1).astype(np.float32)
        per_song[f"{seconds}s_song_ms"] = cuda_ms(
            torch, lambda: separate.separate_wav(model, y), reps=5,
            warmup=2)
        v = separate.separate_wav(model, y)
        check(v.shape == y.shape and np.isfinite(v).all(),
              "separate_wav: shape and finite")
    print("separate_wav: " + json.dumps(per_song))
    busy = device_breakdown(torch, lambda: separate.separate_wav(model, y),
                            "separate_wav 240-s song")
    idle = 1.0 - busy / per_song["240s_song_ms"]
    print(f"separate_wav 240-s song: device busy {busy:.3f} ms of "
          f"{per_song['240s_song_ms']:.3f} ms, idle share {idle:.3f}")
    print("decode graph: " + json.dumps(decode_graph_check(torch, np,
                                                           model)))
    return launches


# the decode graph check's songs (seconds at 8192 Hz), its calls timed by
# CUDA events, and the signatures held against the eager body bit for bit
GRAPH_SECONDS, GRAPH_REPS = (SONG_SECONDS, 4 * 60), 5
# (label, mode, vocal_solo, both, pcm16)
GRAPH_CASES = (("segments", "segments", True, False, False),
               ("overlap", "overlap", True, False, False),
               ("whole", "whole", True, False, False),
               ("vocal_solo_off", "segments", False, False, False),
               ("both", "segments", True, True, False),
               ("pcm16", "segments", True, False, True))


def decode_graph_check(torch, np, model) -> dict:
    """The decode as cached captured programs (``infer/graphs.py``) at
    the full ``default`` width, on a 60-s and a 4-minute song: each
    program's replay against the eager body (``_separate_padded``, its
    PCM16 form) bit for bit in every mode, with ``vocal_solo`` off,
    ``both=True`` and PCM16 (0 LSB); ms a call of ``separate_wav`` and of
    the padded decode on the card, graph and eager, by CUDA events over
    GRAPH_REPS calls; the first call's warm-up and capture (host clock);
    the device's busy and idle share of one traced call each; the bytes
    each program and the cache hold; a rebound model captured again; and
    at float32 the eager body's own spread under cuDNN's default
    algorithms, and the replay's bits under deterministic ones.  Returns
    the ``decode graph:`` line."""
    from svs_torch.infer import graphs, separate
    from svs_torch.models.unet import UNet

    cfg = model.cfg
    dev = next(model.parameters()).device
    cache = graphs.CACHE
    cache.clear()
    rng = np.random.default_rng(7)
    line = {"max_bytes": cache.max_bytes}

    def padded(y, n_pad):
        return torch.from_numpy(np.pad(y, (0, n_pad - len(y)))).to(dev)

    def eager_wav(y, model=model):
        """``separate_wav``'s work with the body run eagerly."""
        n = len(y)
        with torch.inference_mode():
            out = separate._separate_padded(
                model, padded(y, separate._padded_len(n, model.cfg)),
                model.cfg, True, False, "segments")
        return out[:n].cpu().numpy()

    for seconds in GRAPH_SECONDS:
        tag = f"{seconds}s"
        y = (rng.standard_normal(seconds * SR) * 0.1).astype(np.float32)
        y16 = (y * 32768.0).clip(-32768, 32767).astype(np.int16)
        n = len(y)
        n_pad = separate._padded_len(n, cfg)
        worst = {}
        for label, mode, vocal_solo, both, pcm16 in GRAPH_CASES:
            signature, body = separate._wav_body(cfg, vocal_solo, both,
                                                 mode, pcm16)
            x = padded(y16 if pcm16 else y, n_pad)
            builds = cache.builds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = separate._run(model, dev, x, signature, body)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            with torch.inference_mode():
                want = body(model, x)
            check(cache.builds == builds + 1,
                  f"decode graph {tag} {label}: its first call captures")
            prog = cache.program(model, signature, x, body)
            check(cache.builds == builds + 1,
                  f"decode graph {tag} {label}: the second lookup hits")
            diff = max(float((g[:n].double() - w[:n].double()).abs().max())
                       for g, w in zip(got, want))
            worst[label] = diff
            line[f"{tag}_{label}_program_bytes"] = prog.nbytes
            line[f"{tag}_{label}_first_call_s"] = first_s
            check(diff == 0.0, f"decode graph {tag} {label}: the replay is "
                               f"the eager body's bits (max diff {diff})")
            # the entry points through the same program
            if pcm16:
                (o,) = separate.separate_wav_stream(model, [y16], pcm16=True)
                w16 = want[0][:n].cpu().numpy()
                check(np.array_equal(o, w16), f"decode graph {tag}: the "
                      "PCM16 stream is the eager body's codes (0 LSB)")
            elif both:
                o = separate.separate_wav(model, y, both=True)
                check(all(np.array_equal(a, b[:n].cpu().numpy())
                          for a, b in zip(o, want)),
                      f"decode graph {tag}: separate_wav(both=True) is the "
                      "eager body's bits")
            else:
                o = separate.separate_wav(model, y, vocal_solo=vocal_solo,
                                          mode=mode)
                check(np.array_equal(o, want[0][:n].cpu().numpy()),
                      f"decode graph {tag} {label}: separate_wav is the "
                      "eager body's bits")
            check(cache.builds == builds + 1,
                  f"decode graph {tag} {label}: the entry point replayed")
        line[f"{tag}_max_abs_diff"] = worst

        # ms a call, graph and eager: separate_wav (host to host) and the
        # padded decode with its input on the card
        signature, body = separate._wav_body(cfg, True, False, "segments",
                                             False)
        x = padded(y, n_pad)

        def graph_device():
            return separate._run(model, dev, x, signature, body)

        @torch.inference_mode()
        def eager_device():
            return body(model, x)

        runs = {"wav_graph": lambda: separate.separate_wav(model, y),
                "wav_eager": lambda: eager_wav(y),
                "device_graph": graph_device, "device_eager": eager_device}
        for name, fn in runs.items():
            line[f"{tag}_{name}_ms"] = cuda_ms(torch, fn, reps=GRAPH_REPS,
                                               warmup=2)
        for name in ("wav_graph", "wav_eager"):
            busy = device_breakdown(torch, runs[name],
                                    f"decode graph {tag} {name}")
            line[f"{tag}_{name}_busy_ms"] = busy
            line[f"{tag}_{name}_idle_share"] = (
                1.0 - busy / line[f"{tag}_{name}_ms"])
    line["programs"] = len(cache)
    line["cache_bytes"] = cache.nbytes
    line["builds"] = cache.builds
    check(len(cache) == len(GRAPH_SECONDS) * len(GRAPH_CASES),
          "decode graph: one program per signature and bucket")

    # a rebound model (new tensors, the same values) is captured again,
    # and its answer is still the eager body's
    y = (rng.standard_normal(SONG_SECONDS * SR) * 0.1).astype(np.float32)
    builds = cache.builds
    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()}, assign=True)
    o = separate.separate_wav(model, y)
    line["rebind_builds"] = cache.builds - builds
    check(cache.builds == builds + 1,
          "decode graph: a rebound model is captured again")
    check(np.array_equal(o, eager_wav(y)),
          "decode graph: the rebound model's program is the eager bits")

    # float32 convs: cuDNN's default algorithms need not give the same
    # bits twice, so the eager body repeats itself (and a replay can equal
    # it) only under deterministic algorithms, which key their own program
    f32 = UNet(dataclasses.replace(cfg, compute_dtype="float32"),
               generator=torch.Generator().manual_seed(0)).to(dev).eval()
    line["f32_eager_rerun_max_abs_diff"] = float(
        np.abs(eager_wav(y, f32) - eager_wav(y, f32)).max())
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        o = separate.separate_wav(f32, y)
        same = (np.array_equal(o, eager_wav(y, f32))
                and np.array_equal(eager_wav(y, f32), eager_wav(y, f32)))
    finally:
        torch.backends.cudnn.deterministic = was
    check(same, "decode graph: float32, cuDNN deterministic: the eager body "
                "repeats itself and the replay is its bits")
    return line


# the serve phase: serve_cli in its own process at the full ``default``
# preset, answering serial requests of one 60-s song and a burst of distinct
# songs, each held against separate_wav in this process
SERVE_SERIAL, SERVE_BURST = 50, 8
SERVE_WARMUP_S = 60
# seconds for serve_cli to load, warm up and bind, and to drain and exit
SERVE_START_S, SERVE_EXIT_S = 300, 120
# the burst's first requests (path, sample rate, channels); the rest are
# 8192-Hz mono songs at the server's defaults
SERVE_ODD = (("/separate?vocal_solo=0", SR, 1),
             ("/separate?mode=segments", SR, 1),
             ("/separate?mode=whole", SR, 1), ("/separate", 44100, 2))
# a response against the same decode in this process, both PCM16 encoded
# on the host: the same kernels at the same shapes (the server's stream
# runs them on another stream), so one code apart at most
SERVE_LSB = 1
# amplitude_to_db on the card against the CPU: float32 log10 on two
# backends (tests/test_torch_viz.py's bound against svs_tpu)
DB_RTOL = DB_ATOL = 1e-5


def _http(port: int, method: str, path: str, body=None, headers=(),
          connected=None):
    """One request to 127.0.0.1:port with exactly the headers given (none
    added); ``connected`` is set once the connection is open.  Returns
    (status, body)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.connect()
        if connected is not None:
            connected.set()
        conn.putrequest(method, path, skip_accept_encoding=True)
        for k, v in headers:
            conn.putheader(k, v)
        conn.endheaders(body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _post_wav(port: int, path: str, body: bytes, connected=None):
    return _http(port, "POST", path, body,
                 [("Content-Length", str(len(body)))], connected)


def _healthz(port: int) -> dict:
    status, body = _http(port, "GET", "/healthz")
    check(status == 200, f"/healthz answers 200, not {status}")
    return json.loads(body)


def _burst(port: int, requests, before_join=None):
    """POST every (path, body) at once from its own thread; returns the
    (status, body, seconds from the burst's start to its answer) of each
    and the wall seconds of the burst.  ``before_join`` runs once every
    connection is open."""
    import threading
    results = [None] * len(requests)
    opened = [threading.Event() for _ in requests]

    def post(i):
        try:
            status, body = _post_wav(port, *requests[i], connected=opened[i])
        except OSError as e:
            status, body = repr(e), b""
        results[i] = (status, body, time.perf_counter() - t0)

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if before_join is not None:
        for e in opened:
            check(e.wait(timeout=60), "every burst connection opened")
        before_join()
    for t in threads:
        t.join(timeout=SERVE_START_S)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          "no request of the burst hangs")
    return results, wall


def serve_phase(torch, np, work: str) -> dict:
    """``python -m svs_torch.cli.serve_cli`` on the slice's full-width
    ``default`` .pth, driven over HTTP; returns the ``serve:`` line."""
    import signal
    import socket
    from urllib.parse import parse_qs

    from svs_torch.cli import infer_cli, viz_cli
    from svs_torch.data import wav
    from svs_torch.infer import separate
    from svs_torch.ops import stft as tdsp
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.serve.server import DEFAULT_MAX_BODY, DEFAULT_MODE
    from svs_torch.utils.config import get_config

    # the host resampler's module, imported here (and timed, if this is its
    # first import) so that the import is not timed as resampling;
    # serve_cli imports it at warmup, not in a request
    t0 = time.perf_counter()
    import scipy.signal  # noqa: F401
    line = {"scipy_signal_import_s": time.perf_counter() - t0}

    cfg = get_config("default")
    pth = os.path.join(work, "default_seed0.pth")
    rng = np.random.default_rng(4)

    def song_body(sr: int, channels: int) -> bytes:
        t = np.arange(SONG_SECONDS * sr) / sr
        vocal = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 600) * t)
        y = vocal + 0.2 * rng.standard_normal((channels, len(t)))
        return wav.encode_wav(y.astype(np.float32), sr)

    model = infer_cli.load_model(pth, cfg, "cuda")

    resample_s = []  # host seconds of each resampling, there and back

    def resampled(y, sr_from: int, sr_to: int):
        t0 = time.perf_counter()
        y = wav.resample(y, sr_from, sr_to)
        resample_s.append(time.perf_counter() - t0)
        return y

    def host_input(body: bytes):
        y, sr = wav.parse_wav(body)
        y = wav.to_mono(y)
        return (resampled(y, sr, SR) if sr != SR else y), sr

    def in_process(path: str, body: bytes) -> bytes:
        """What the server should answer: the same parse, mixdown and
        resampling around separate_wav on the card, encoded as PCM16."""
        q = parse_qs(path.partition("?")[2])
        y, sr = host_input(body)
        out = separate.separate_wav(
            model, y.astype(np.float32),
            vocal_solo=q.get("vocal_solo", ["1"])[0] != "0",
            mode=q.get("mode", [DEFAULT_MODE])[0])
        return wav.encode_wav(resampled(out, SR, sr) if sr != SR
                              else out, sr)

    def lsb(got: bytes, want: bytes) -> int:
        (g, g_sr), (w, w_sr) = wav.parse_wav(got), wav.parse_wav(want)
        check(g_sr == w_sr and g.shape == w.shape and np.abs(w).max() > 0,
              f"a response's rate and shape: {g_sr} {g.shape} against "
              f"{w_sr} {w.shape}")
        return int(np.abs(np.round(g * 32768.0)
                          - np.round(w * 32768.0)).max())

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log_path = os.path.join(work, "serve_cli.log")

    def server_log() -> str:
        with open(log_path) as f:
            return f.read()

    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "svs_torch.cli.serve_cli",
             "--model_path", pth, "--port", str(port),
             "--warmup_secs", str(SERVE_WARMUP_S)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while True:
            check(proc.poll() is None,
                  f"serve_cli exited ({proc.returncode}) before it "
                  f"answered:\n{server_log()}")
            try:
                if _http(port, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < SERVE_START_S,
                  f"serve_cli answered /healthz within {SERVE_START_S} s:"
                  f"\n{server_log()}")
            time.sleep(0.2)
        line["startup_s"] = time.perf_counter() - t0

        # serial: one song, one request after another
        body = song_body(SR, 1)
        want = in_process("/separate", body)
        serial, worst = [], 0
        for _ in range(SERVE_SERIAL):
            t0 = time.perf_counter()
            status, got = _post_wav(port, "/separate", body)
            serial.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"serial request: 200, not {status}")
            worst = max(worst, lsb(got, want))
        line["serial_ms"] = serial
        line["serial_p50_ms"] = float(np.percentile(serial, 50))
        line["serial_p90_ms"] = float(np.percentile(serial, 90))
        # the window holds the warmup and the serial requests' stream calls
        line["serial_device_time_secs"] = {
            k: _healthz(port)["device_time_secs"][k] for k in ("p50", "p90")}

        # a burst of distinct songs, some with other queries and rates
        rates = [sr for _, sr, _ in SERVE_ODD] + [SR] * (
            SERVE_BURST - len(SERVE_ODD))
        requests = [(path, song_body(sr, ch)) for path, sr, ch in
                    SERVE_ODD + (("/separate", SR, 1),)
                    * (SERVE_BURST - len(SERVE_ODD))]
        results, wall = _burst(port, requests)
        for (path, b), (status, got, _) in zip(requests, results):
            check(status == 200, f"burst {path}: 200, not {status}")
            worst = max(worst, lsb(got, in_process(path, b)))
        print(f"serve check: {SERVE_SERIAL} serial and {SERVE_BURST} burst "
              f"responses against separate_wav in this process: max "
              f"{worst} LSB (bound {SERVE_LSB})")
        check(worst <= SERVE_LSB, "the server's answers are separate_wav's")
        # throughput over the songs at the model's rate; the 44.1-kHz
        # song waits on the host resampler, so its latency stands apart
        same = [r[2] for r, sr in zip(results, rates) if sr == SR]
        line.update(burst_wall_s=wall, burst_request_s=[r[2] for r in results],
                    burst_same_rate_songs=len(same),
                    burst_same_rate_wall_s=max(same),
                    burst_same_rate_songs_per_s=len(same) / max(same),
                    burst_44k1_request_s=[r[2] for r, sr in zip(results, rates)
                                          if sr != SR],
                    max_lsb=worst, resample_44k1_s=resample_s[-2:])
        h = _healthz(port)
        served = 1 + SERVE_SERIAL + SERVE_BURST  # the warmup is one
        check(h["requests_served"] == served,
              f"/healthz requests_served {h['requests_served']} == {served}")
        check(h["max_coalesced"] > 1, f"the burst was coalesced: "
              f"max_coalesced {h['max_coalesced']}")
        for window in ("queue_wait_secs", "device_time_secs"):
            check(all(v is not None for v in h[window].values()),
                  f"/healthz {window} has percentiles")
            line[window] = {k: h[window][k] for k in ("p50", "p90")}
        line["max_coalesced"] = h["max_coalesced"]
        line["batches_run"] = h["batches_run"]

        # a serial request's device share: the device time of the one-song
        # stream call the worker makes for it (traced in this process, no
        # coalescing) over the serial p50 on the client
        y1 = host_input(body)[0].astype(np.float32)
        separate.separate_wav_stream(model, [y1], mode=DEFAULT_MODE)
        line["serial_request_device_ms"] = device_breakdown(
            torch, lambda: separate.separate_wav_stream(
                model, [y1], mode=DEFAULT_MODE),
            "serve check: in-process stream of the serial 60-s song")
        line["serial_device_share"] = (line["serial_request_device_ms"]
                                       / line["serial_p50_ms"])

        # for scale: the burst's songs through one stream call in this
        # process, the hand kernels' counts zeroed just before
        ys = [host_input(b)[0].astype(np.float32) for _, b in requests]
        separate.separate_wav_stream(model, ys, mode=DEFAULT_MODE)
        cdsp.reset_counts(), cdm.reset_counts(), cfl.reset_counts()
        t0 = time.perf_counter()
        outs = separate.separate_wav_stream(model, ys, mode=DEFAULT_MODE)
        line["stream_in_process_s"] = time.perf_counter() - t0
        line["hand_kernel_launches"] = (
            cdsp.launches + cdsp.mag_launches + sum(_loss_counts()[0]))
        check(all(o.shape == y.shape and np.isfinite(o).all()
                  for o, y in zip(outs, ys)), "the stream: shape, finite")
        line["stream_device_ms_per_song"] = device_breakdown(
            torch, lambda: separate.separate_wav_stream(
                model, ys, mode=DEFAULT_MODE),
            f"serve check: in-process stream of {SERVE_BURST} 60-s songs"
        ) / SERVE_BURST

        # the error paths
        codes = {
            "unknown_path_get": (_http(port, "GET", "/nope")[0], 404),
            "unknown_path_post": (_post_wav(port, "/nope", body)[0], 404),
            "bad_body": (_post_wav(port, "/separate", b"not a wav")[0], 400),
            "bad_mode": (_post_wav(port, "/separate?mode=bogus", body)[0],
                         400),
            "no_content_length": (_http(port, "POST", "/separate")[0], 411),
            "oversize": (_http(port, "POST", "/separate", None, [
                ("Content-Length", str(DEFAULT_MAX_BODY + 1))])[0], 413),
        }
        for what, (got, want_code) in codes.items():
            check(got == want_code, f"{what}: {want_code}, not {got}")

        # SIGTERM while a second burst is in flight: once every connection
        # is open and the server has answered one of them
        def sigterm():
            for _ in range(SERVE_START_S * 100):
                if _healthz(port)["requests_served"] > served:
                    break
                time.sleep(0.01)
            proc.send_signal(signal.SIGTERM)

        results, _ = _burst(port, requests, before_join=sigterm)
        statuses = [r[0] for r in results]
        check(all(s in (200, 503) for s in statuses),
              f"every request under SIGTERM ends 200 or 503: {statuses}")
        t0 = time.perf_counter()
        rc = proc.wait(timeout=SERVE_EXIT_S)
        check(rc == 0, f"serve_cli exits 0 after SIGTERM, not {rc}:\n"
                       f"{server_log()}")
        line["sigterm"] = {"ok": statuses.count(200),
                           "unavailable": statuses.count(503),
                           "exit_s": time.perf_counter() - t0}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # the diagnostics on the card
    mix_path = os.path.join(work, "spec", "mixture", "0000_song0_spec.npy")
    mix = torch.from_numpy(np.load(mix_path))
    db_card = tdsp.amplitude_to_db(mix.cuda(), ref=float(mix.max()))
    db_cpu = tdsp.amplitude_to_db(mix, ref=float(mix.max()))
    err = float((db_card.cpu() - db_cpu).abs().max())
    print(f"serve check: amplitude_to_db on the card against the CPU: "
          f"max_abs_err {err:.3e} dB")
    check(torch.allclose(db_card.cpu(), db_cpu, rtol=DB_RTOL, atol=DB_ATOL),
          "amplitude_to_db on the card matches the CPU")
    png = os.path.join(work, "viz.png")
    argv = ["--model_path", pth, "--spec_path", mix_path, "--out", png,
            "--device", "cuda"]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        try:
            viz_cli.main(argv)
        except ImportError as e:
            check("matplotlib" in str(e), "the ImportError names matplotlib")
            line["viz_cli"] = f"no matplotlib here; it raised: {e}"
        else:
            check(False, "viz_cli without matplotlib raises ImportError")
    else:
        check(viz_cli.main(argv) == 0 and os.path.getsize(png) > 10000,
              "viz_cli wrote its figure")
        line["viz_cli"] = "figure written"
    print(f"serve check: viz_cli --device cuda: {line['viz_cli']}")
    return line


def run_cli(main, argv) -> dict:
    """Run a CLI's ``main(argv)``, echo what it printed, return its last
    line as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"{' '.join(argv)}: exit code 0")
    return json.loads(text.strip().splitlines()[-1])


def bench_phase(torch, np, spec: str):
    """The bench entry point (``bench_cli``) at the full ``default`` preset
    on the card, with the counts zeroed just before each run and read just
    after; then the PCM16 stream against ``separate_wav`` and the
    device-resident batches against the host sampler's.  Returns the launch
    counts of the ``--frontend`` run."""
    from svs_torch.cli import bench_cli
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.data.device_data import DeviceDataset
    from svs_torch.infer import separate
    from svs_torch.models.unet import UNet
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.ops.cuda import fused_loss as cfl
    from svs_torch.utils.benchmark import _music_fixture
    from svs_torch.utils.config import get_config

    def zero():
        cdsp.reset_counts()
        cdm.reset_counts()
        cfl.reset_counts()

    def counts():
        return {"stft_magphase": cdsp.launches,
                "stft_magnitude": cdsp.mag_launches,
                "spectral_mag_fwd": cdm.fwd_launches,
                "spectral_mag_bwd": cdm.bwd_launches,
                "loss_partials_fwd": cfl.fwd_launches,
                "loss_partials_bwd": cfl.bwd_launches}

    seconds = {}
    t0 = time.perf_counter()
    zero()
    front = run_cli(bench_cli.main, ["--frontend", "--device", "cuda"])
    launches = counts()
    routes = {r: getattr(cdsp, f"{r}_launches")
              for r in ("fft", "mixed", "gemm")}
    seconds["frontend_s"] = time.perf_counter() - t0
    print("bench --frontend launches: " + json.dumps(launches)
          + ", front ends by route " + json.dumps(routes))
    check(routes == {"fft": 204, "mixed": 0, "gemm": 0},
          "bench --frontend went through the fft route only")
    # one warm-up, 100 timed calls and one for the error, each front end
    check(launches["stft_magnitude"] == 102
          and launches["stft_magphase"] == 102,
          "bench --frontend launched each front-end kernel 102 times")
    check(front["mag_max_abs_err"] < ATOL
          and front["magphase_max_abs_err"] < ATOL,
          "bench --frontend: kernels agree with torch.stft within the "
          "kernel tolerance")

    t0 = time.perf_counter()
    zero()
    # 60-s songs, 2 a stream (the line's defaults are 240 s and 5): the
    # checks below hold for any length
    line = run_cli(bench_cli.main, ["--device", "cuda", "--secs", "60",
                                    "--reps", "2"])
    seconds["default_line_s"] = time.perf_counter() - t0
    print("bench default line launches: " + json.dumps(counts()))
    errors = [k for k in line if k.endswith("_error")]
    check(not errors, f"bench default line: no sub-bench failed {errors}")
    numbers = {k: v for k, v in line.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    check(all(math.isfinite(v) and v > 0 for v in numbers.values()),
          f"bench default line: every number finite and positive {numbers}")
    for key in ("decode_device_ms_per_song",
                "decode_device_eager_ms_per_song", "stream_frames_per_sec",
                "train_step_ms", "train_step_eager_ms",
                "train_patches_per_sec",
                "train_patches_per_sec_device"):
        check(key in numbers, f"bench default line has {key}")
    # the default loss runs the loss kernels on the card, which the FLOP
    # counter cannot see: no partial count, no MFU
    check(line.get("train_flops_per_step", 0) is None
          and line.get("train_mfu_pct", 0) is None,
          "bench default line: no train FLOPs or MFU under the loss kernels")
    check(line["train_mr_mag_impl"] == "matmul_bf16"
          and line["train_dtype"] == "bfloat16",
          "bench default line: the shipped default preset")

    # the PCM16 stream (two songs, so one's copies overlap the other's
    # decode) against separate_wav on the first, same card and weights
    t0 = time.perf_counter()
    cfg = get_config("default")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    songs = [_music_fixture(n * SR, SR, seed=s, pcm16=True)
             for s, n in ((3, SONG_SECONDS), (4, 30))]
    outs = separate.separate_wav_stream(model, songs, pcm16=True,
                                        device="cuda")
    check([o.dtype for o in outs] == [np.int16] * 2
          and [o.shape for o in outs] == [y.shape for y in songs],
          "PCM16 stream: int16 outputs of the songs' lengths")
    want = separate.separate_wav(model, songs[0].astype(np.float32) / 32768,
                                 device="cuda")
    lsb = np.abs(outs[0].astype(np.float64) - want * 32768.0).max()
    f32 = separate.separate_wav_stream(
        model, [s.astype(np.float32) / 32768 for s in songs], device="cuda")
    f32_err = float(np.abs(f32[0] - want).max())
    print(f"bench: PCM16 stream vs separate_wav, 60-s song: max {lsb:.3f} "
          f"LSB (bound 2); f32 stream vs separate_wav: max_abs_err "
          f"{f32_err:.3e}")
    check(lsb <= 2.0, "PCM16 stream within 2 LSB of separate_wav")
    check(f32_err <= 1e-5, "f32 stream matches separate_wav")

    # the device-resident dataset on the card against the host sampler
    ds = PatchDataset(spec, samples_per_song=64, input_len=128)
    dev = DeviceDataset(ds, device="cuda")
    n_batches = 0
    for kw in (dict(seed=5, n_steps=3), dict(seed=6, drop_last=True)):
        for hb, db in zip(ds.batches(TRAIN_B, **kw),
                          dev.batches(TRAIN_B, **kw)):
            for k, v in hb.items():
                check(torch.equal(db[k].cpu(), torch.from_numpy(v)),
                      f"DeviceDataset batch {k} equals the host's")
            n_batches += 1
    print(f"bench: DeviceDataset on the card, {n_batches} batches of "
          f"{TRAIN_B} bitwise equal to the host PatchDataset's "
          f"({dev.nbytes / 2**20:.1f} MiB resident)")
    seconds["stream_and_data_checks_s"] = time.perf_counter() - t0
    print("bench seconds: " + json.dumps(seconds))
    return launches


# kernel-name fragments -> the layer they belong to (profiler breakdowns)
FAMILIES = (("conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "dgrad",
                      "wgrad", "nchw", "nhwc")),
            ("fft", ("fft",)),
            ("copy", ("memcpy", "memset")))


def device_breakdown(torch, fn, label: str, families=FAMILIES,
                     kernels=None) -> float:
    """Device time of one ``fn()`` call by kernel family, from a
    torch.profiler trace; returns the summed device milliseconds.
    ``kernels``: a dict that takes the loss kernels' launches in the trace
    (``_kernel_of``)."""
    by_family, n_kernels = {}, 0
    for key, ms, count in device_events(torch, fn, cpu=True):
        if kernels is not None and _kernel_of(key):
            kernels[_kernel_of(key)] = kernels.get(_kernel_of(key), 0) + count
        name = key.lower()
        family = next((f for f, keys in families
                       if any(k in name for k in keys)), "elementwise")
        by_family[family] = by_family.get(family, 0.0) + ms
        n_kernels += count
    busy = sum(by_family.values())
    check(busy > 0, f"the profiler saw device time in {label}")
    print(f"{label} device ms by family: "
          + json.dumps(dict(by_family, kernels=n_kernels)))
    return busy


def parity_phase(torch):
    from svs_torch.models.unet import UNet
    from svs_torch.utils.config import get_config

    cfg = dataclasses.replace(get_config("default"), compute_dtype="float32")
    cpu = UNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu = UNet(cfg).cuda().eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.rand((2, 512, 128), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = cpu(x)
        got = gpu(x.cuda()).cpu()
    err = (got - want).abs().max().item()
    print(f"parity: default-width U-Net, float32, cuDNN (TF32 off) vs CPU: "
          f"max_abs_diff mask={err:.3e} (bound {UNET_F32_ATOL:g})")
    check(err < UNET_F32_ATOL, "U-Net float32 on the card matches the CPU")


def loss_times_main(tree: str) -> int:
    """``--loss-times TREE``: only the loss kernels' times (``loss_times``)
    through the ``svs_torch`` of the source tree TREE (an earlier version
    unpacked beside this one, or this one), as one JSON line; for timing
    two designs in one run on one card."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    check(cdm.__file__.startswith(tree + os.sep), f"svs_torch from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    times = loss_times(torch, np, cdm, cfl)
    print(json.dumps({"tree": tree, "device": nvidia_smi_line(),
                      "loss_times": times}))
    return 0


def _add_counts(into: dict, counts: dict) -> None:
    """``layout_programs``' launch counts of a phase, added into ``into``."""
    for name, c in counts.items():
        mine = into.setdefault(name, {k: 0 for k in c})
        for k, v in c.items():
            mine[k] += v


def main(argv=None) -> int:
    import numpy as np
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--loss-times"] and len(argv) == 2:
        return loss_times_main(argv[1])
    check(not argv, f"unknown arguments {argv}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from svs_torch.ops.cuda import build
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import dsp as cdsp
    from svs_torch.ops.cuda import fused_loss as cfl

    # every f32 comparison on the card is true f32: cuDNN's convs and
    # cuBLAS's matmuls would otherwise round operands to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 off for cudnn and matmul")

    seconds = {}
    t0 = time.perf_counter()
    build_phase(build, [*cdsp.KERNELS, cdm.KERNEL, cfl.KERNEL,
                        "phase_clock"], [cdm.KERNEL, cfl.KERNEL])
    seconds["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_clock_phase(torch, np)
    seconds["clocks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    entries = [frontend_phase(torch, np, cdsp, phase=True),
               frontend_phase(torch, np, cdsp, phase=False)]
    entries += loss_kernel_phase(torch, np)
    seconds["kernels"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as work:
        t0 = time.perf_counter()
        launches = slice_phase(torch, np, work)
        seconds["slice"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_line = serve_phase(torch, np, work)
        seconds["serve"] = time.perf_counter() - t0
        print("serve: " + json.dumps(serve_line))
        t0 = time.perf_counter()
        train_launches, batch = train_phase(torch, np,
                                            os.path.join(work, "spec"))
        seconds["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bench_launches = bench_phase(torch, np, os.path.join(work, "spec"))
        seconds["bench"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fit_launches = fit_phase(torch, np, work)
        seconds["fit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        step_counts = step_graph_phase(torch, np, work)
        seconds["step_graph"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        scan_counts = scan_phase(torch, np, work)
        seconds["scan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native_phase(torch, np, work)
        seconds["native"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_phase(torch, np, work)
        seconds["eval"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dp_counts, backend, layout_counts = dp_phase(
            torch, np, os.path.join(work, "spec"))
        seconds["dp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dpscan_counts = dpscan_phase(torch, np, work)
        seconds["dpscan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zero_counts, counts = zero_phase(
            torch, np, os.path.join(work, "spec"), backend)
        _add_counts(layout_counts, counts)
        seconds["zero"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp_counts, counts = tp_phase(torch, np, os.path.join(work, "spec"),
                                     backend)
        _add_counts(layout_counts, counts)
        seconds["tp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pp_counts, counts = pp_phase(torch, np, work)
        _add_counts(layout_counts, counts)
        seconds["pp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cp_counts, counts = cp_phase(torch, np, work, backend)
        _add_counts(layout_counts, counts)
        seconds["cp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mh_counts = mh_phase(torch, np, work)
        seconds["mh"] = time.perf_counter() - t0
    print("train phase launches: " + json.dumps(train_launches))
    # the loss kernels' launches on the paths that run them: fit under the
    # kernel loss paths (the fit phase's per-step fits, whose steps are
    # make_train_step's program: the wrappers' launches in its eager
    # warm-up step, their calls recorded into its capture and the replays'
    # launches that the profiler saw in those fits), and fit with
    # epoch_scan: the wrappers' eager launches there (warm-up step, tails,
    # validation), the calls they recorded into the graphs, and the
    # replays' launches that the profiler saw in those fits
    launches.update({k: v[0] for k, v in fit_launches.items()})
    launches["stft_magnitude"] = bench_launches["stft_magnitude"]
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        check(entry["launches"] > 0,
              f"{entry['name']} launched on its main path")
        if entry["name"] in fit_launches:
            _, entry["fit_captured"], entry["fit_replay_launches"] = \
                fit_launches[entry["name"]]
            check(entry["fit_captured"] > 0
                  and entry["fit_replay_launches"] > 0,
                  f"{entry['name']} captured and replayed in the per-step "
                  "fit's program")
        if entry["name"] in step_counts:
            # the step graph phase's program calls: eager, captured and
            # replayed (a traced replay's count times the replays)
            entry["step_graph_launches"] = step_counts[entry["name"]]
            check(all(v > 0 for v in entry["step_graph_launches"].values()),
                  f"{entry['name']} launched, captured and replayed by the "
                  "step programs")
        if entry["name"] in layout_counts:
            # the layouts' programs at a world of one (dp, zero1, fsdp, tp,
            # cp) under the kernel paths: the wrappers' launches in the
            # programs' warm-up steps, their calls captured, and the
            # replays' launches from torch.profiler traces of the calls
            entry["layout_graph_launches"] = layout_counts[entry["name"]]
            check(all(v > 0 for v in
                      entry["layout_graph_launches"].values()),
                  f"{entry['name']} launched, captured and replayed by the "
                  "layouts' programs")
        if entry["name"] in scan_counts:
            entry.update(scan_counts[entry["name"]])
            check(entry["scan_launches"] > 0 and entry["scan_captured"] > 0
                  and entry["replay_launches"] > 0,
                  f"{entry['name']} launched and replayed under epoch_scan")
        if entry["name"] in dp_counts:
            # the DP steps' own count, zeroed just before and read after
            entry["dp_launches"] = dp_counts[entry["name"]]
            check(entry["dp_launches"] > 0,
                  f"{entry['name']} launched inside the DP step")
        if entry["name"] in dpscan_counts:
            # the world-of-one mesh graph fits': the wrappers' eager
            # launches, their calls recorded into a graph and the replays'
            # launches, as the scan phase counts them
            entry["dpscan_launches"] = dpscan_counts[entry["name"]]
            check(all(v > 0 for v in entry["dpscan_launches"].values()),
                  f"{entry['name']} launched, captured and replayed inside "
                  "the mesh graph fits")
        if entry["name"] in zero_counts:
            # the world-of-one ZeRO-1 and FSDP steps' own count
            entry["zero_launches"] = zero_counts[entry["name"]]
            check(entry["zero_launches"] > 0,
                  f"{entry['name']} launched inside the sharded steps")
        if entry["name"] in tp_counts:
            # the (1, 1) TP steps' own count
            entry["tp_launches"] = tp_counts[entry["name"]]
            check(entry["tp_launches"] > 0,
                  f"{entry['name']} launched inside the TP steps")
        if entry["name"] in pp_counts:
            # the PP steps' own count, on the one card
            entry["pp_launches"] = pp_counts[entry["name"]]
            check(entry["pp_launches"] > 0,
                  f"{entry['name']} launched inside the PP steps")
        if entry["name"] in cp_counts:
            # the world-of-one CP steps' own count
            entry["cp_launches"] = cp_counts[entry["name"]]
            check(entry["cp_launches"] > 0,
                  f"{entry['name']} launched inside the CP steps")
        if entry["name"] in mh_counts:
            # rank 0's two-host steps' own count
            entry["mh_launches"] = mh_counts[entry["name"]]
            check(entry["mh_launches"] > 0,
                  f"{entry['name']} launched inside the two-host steps")

    t0 = time.perf_counter()
    parity_phase(torch)
    step_parity_phase(torch, np, batch)
    seconds["parity"] = time.perf_counter() - t0
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}))

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
