#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. setup — the card's name and power limit (``nvidia-smi``), then every
   CUDA kernel built from ``src/repro_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (all sources compiled at once);
2. kernel parity — each kernel against its plain PyTorch version on the
   card, at the main path's shapes, float32 and bfloat16, every layout
   (the flux kernel with λx != λy; the eikonal kernel: inner 1 and 4,
   tiles (8, 128) and (64, 256), on a mid-solve state; the SSD kernel also
   at the tile registry's chunk of 256); the bfloat16 limits of the
   eikonal, attention and SSD kernels each shown to see a deliberately
   wrong variant (for the SSD also the designs its bf16 route rejects: S'
   and the state weights each rounded once to bfloat16; at chunk 256, in
   both dtypes, a kernel that drops what the second 128-row tile takes
   from the first); the attention kernel also at head dim 256, the
   prefill shapes of gemma3-12b's local (window 1024) and global layers
   and of recurrentgemma-9b's local layers (one KV head, window 2048),
   where at gemma3-12b's local shape the kernel run without its window
   must fall outside the limit;
3. the main path through the port's ``Graph``/``Executor`` on the GPU:
   the Table 2 SAXPY probe (n = 2^24), the particle step graph (2^24
   particles per species, 100 steps, closed-form check), the FORCE flux
   graph on a 4096 x 4096 shock-bubble interior (checked against the
   plain version on the card) and the Table 5 eikonal solve on a 4096 x
   4096 grid, a conditional loop run until no cell changes (checked
   against the plain loop on the card and the exact distance), each
   graph through ``Executor(g, regions=False)`` (one launch a kernel
   call) and then through ``Executor(g)`` at the executor's defaults
   (``regions=True, donate=True``, as the JAX package's: a build calls
   each wrapper twice, the eager warm-up and the capture, and replays
   call none), the two states bit for bit, ms per step both ways; every
   kernel's launch count is read from each run, the counts set to 0
   just before it;
   then the measured autotuner at the defaults (each candidate timed as
   a captured graph): the particle step graph (2^24 particles
   per species, tiles left to the registry) and the flux graph (4096 x
   4096) each constructed with ``Executor(g, tune="auto")`` under a fresh
   tuning cache in ``build/``; the tuned plan's state after 100 steps
   held against the heuristic plan's (bitwise, or the kernels' parity
   limit), both timed per step and one step of each traced with
   ``torch.profiler``, and a second construction checked to load the
   decision with zero new measurements; the wrappers called twice a
   kernel call site a capture (one a measured candidate, one more for
   the heuristic plan when it lost);
   then LM serving through ``Batcher`` -> ``Executor`` at the defaults
   (the decode step captured once, the prefills eager): qwen3-8b at its
   published width and depth (36 layers, bf16, random weights from a
   seeded generator, made on the card) and mamba2-130m at its published
   config, each answering 8 requests (prompts of 2048, 2048, 1536, 1536,
   1000, 1000, 517 and 517 tokens, 32 new tokens each, 4 batch slots,
   ``max_seq`` 2112), through the ``Batcher`` as ``launch/serve.py``
   builds it (prefill-ahead on).  Checked: the flash-attention kernel
   (K6) called once per attention layer per request (its eager prefill)
   and the SSD kernel (K7) likewise per Mamba layer; the serve
   launcher's smoke checks (the decode captured once; a fresh worker
   ``Batcher`` over the same weights serving the 8 requests with no new
   decode capture and equal streams), with tokens/s with and without
   the decode capture; the two batchers, both live, stepped in turn
   (ms a step against one alone, the bytes moved out a step, streams
   unchanged); ragged traffic of 8 distinct lengths (2048 ... 300) with
   the batcher's eager prefills and with one capture per length
   (``captured_prefills``, for comparison), tokens/s each and equal streams; each length's
   captured prefill alone (first call, replay, memory) and the 8
   requests on those replays; the batcher's token streams
   equal the per-request loop's (``per_request_generate``: each row
   prefilled alone, as the batcher does, then the uniform decode) for
   each equal-length pair; the kernel route's last-position prefill
   logits within ``LOGIT_TOL`` of the plain route's on the same weights,
   and a deliberately wrong variant outside it.  Then gemma3-12b (48 layers,
   5 local to 1 global, head dim 256) and recurrentgemma-9b (38 layers,
   RG-LRU and local attention) at their published configs, with the
   same checks (K6 once per attention layer, local or global, per
   request: 384 and 96 launches; the wrong variant: the local layers
   without their window, or, for recurrentgemma-9b, whose window of 2048
   is causal at 2048 tokens, attention without its causal mask) in place
   of the ragged, interleaved and captured-prefill measurements, plus
   one request served alone by a one-slot ``Batcher`` (tokens/s, decode
   ms per step against the weights' read at the memory rate) and the
   ring check: a prompt longer than the window (2048 tokens for
   gemma3-12b, 3072 for recurrentgemma-9b) prefilled and 16 tokens
   teacher-forced through the decode caches, the last step's logits
   within ``RING_TOL`` of one prefill over all of them, and the decode
   with each ring slot's position taken as its index (no wrap) outside
   it;
3g. the remaining dense archs, the encoder-decoder and the VLM (after the
   local-layer models, in phase 3's serving loop): qwen1.5-4b (40 layers,
   QKV bias, MHA 20/20) and chatglm3-6b (28 layers, GQA 32/2, half-dim
   interleaved RoPE) at their published configs through the default
   ``Batcher`` with gemma3-12b's requests and checks (K6 once per layer
   per request: 320 and 224 launches; the decode captured once; a fresh
   worker with no new capture and equal streams; streams equal
   ``per_request_generate``'s; prefill logits within ``LOGIT_TOL``, attention
   without its causal mask outside it; one request alone); then
   seamless-m4t-medium (12 encoder layers over 4096 frames of 1024, 12
   decoder layers with cross-attention, head dim 64) and
   llava-next-mistral-7b (32 layers over 2048 patch positions and the
   text) through the uniform loop (``legacy_generate``, where
   ``launch/serve.py`` sends them): 4 rows of 512 tokens prefilled in
   one call, 32 new each, K6 once per attention layer over the rows (36
   and 32: the encoder's and the cross-attention's too), prefill logits
   within the limit (the encoder run causal, or llava without its
   causal mask, outside it),
   and the decode check: 512 tokens prefilled, 16 teacher-forced through
   the decode step, the last logits within ``FRONTEND_DECODE_TOL`` of one
   prefill of 528 with the same frames or patches (seamless's cross
   caches with their values zeroed, or llava's decode positions without
   the patch positions, outside it); prefill ms a row (seamless's
   encoder alone too), decode ms a step, tokens/s.  K6 is first held
   against its plain version at these archs' prefill shapes (phase 2,
   ``ATTN_SHAPES_3G``: the mask flipped must fall outside the limit)
   and timed there beside its bound and SDPA (phase 4);
3h. the MoE archs (after 3g, in phase 3's serving loop): phi3.5-moe (16
   experts top-2, GQA 32/8) cut to 24 of its 32 layers and arctic-480b
   (128 experts top-2 beside a dense residual FFN, GQA 56/8) cut to 2 of
   its 35, each at its published width (``MOE_LAYERS``; the cut logged
   as reduced), through the default ``Batcher`` with 3g's requests and
   gates (K6 once per layer per request: 192 and 16 launches; the decode,
   which routes dropless, captured once; a fresh worker with no new
   capture and equal streams; one request alone against the weights'
   read), plus: the (token, k) pairs each request's prefill drops at
   capacity factor 1.25 (``_dispatch_slots`` wrapped here); each
   request's stream equal, with no tolerance, to
   ``per_request_generate`` on that request (4 rows of it, each
   prefilled alone, at the batcher's decode width); the
   kernel route's prefill logits within ``LOGIT_TOL`` of the plain
   route's with the plain route replaying the kernel route's expert
   choices (``_top_k`` wrapped here; also printed without the replay,
   with the count of (token, layer) choices that differ), and outside it
   attention without its causal mask, top-1 routing (phi3.5-moe) and no
   dense residual (arctic-480b); K6 at arctic's (1, 56, 8, 2048, 2048,
   128) in phase 2 and 4 with ``ATTN_SHAPES_3G``;
3b. outputs in place and region compile — first K1-K5 with ``out=`` at
   the main path's shapes, float32 and bfloat16, every layout each takes
   (K4's AoSoA through its ops wrapper): ``out`` apart from the inputs,
   and for K1-K3 ``out`` the updated input itself, each bit for bit the
   fresh-output call; then the four graphs of phase 3 at their sizes run with
   ``Executor(g, regions=False)`` and with ``Executor(g, regions=True)`` under
   ``donate=False`` and ``donate=True`` from the same inputs: the final
   states equal bit for bit in every field (the eikonal solve in the same
   745 iterations), zero captures in steady state and for a second
   executor over the same graph, a state from another seed after capture
   equal to the eager run on it (the kernels were recorded into the
   graph, not run once), ms per step or iteration and the device busy
   share of one profiled step both ways; then the 8 requests of qwen3-8b
   and mamba2-130m served again, the batcher's executors eager
   (``regions=False``) and under ``regions=True, donate=True``, with
   equal token streams, tokens/s and decode ms per step both ways (under
   regions one capture per prompt length holding K6 or K7 once a layer,
   and the decode graph copying no layer's cache).  Launch counts: the
   wrappers' counts
   set to 0 before each executor's first call and read after it (a
   build calls each wrapper twice a step, the eager warm-up and the
   capture), then set to 0 again and read after every later call
   (replays call no wrapper: 0); the graphs captured at that call hold
   each kernel of the graph as kernel nodes as often as the eager step
   launches it (K1 twice, K2 once, K3 twice, K4 once a step, K5 once
   an iteration), read from CUDA's DOT print of each graph, and a replay
   runs every node of its graph; the graphs' memcpy nodes (their bytes,
   from the same DOT print) are the copies that aliasing and the halo
   fill force, which ``forced_copies`` states per graph with the reason
   for each (none for the saxpy probe, the particle step and the flux
   step; the eikonal body's ``phi_prev <- phi`` and its padded phi's
   contiguous rows and corners), and ``cache_stats()`` counts no copy
   back; the launches that the profiler's trace
   of a replayed step holds are printed beside them (the trace drops a
   call's first records at times, so it is no gate); the served
   requests' prefills launch K6 and K7 as in phase 3, and the captured
   decode graph copies no layer's cache (its largest memcpy node, and
   what it copies back a step, are below one layer's cache).  These
   counts are checked and not added to the kernels line, whose
   ``launches`` are phase 3's;
3d. mesh — partitioned tensors on a mesh of four shards on the one card
   (``make_mesh(..., devices=["cuda:0"] * k)``; one card cannot show
   scaling): the flux graph at 4096 x 4096 (SoA float32 shock-bubble,
   transmissive halo (1, 1)) unsharded, on a (2, 2) mesh ("gx", "gy")
   with the synchronous lowering and with ``overlap=True``, 20 steps each
   from the same inputs: ``du`` of both mesh runs bit for bit the
   unsharded K4 run's, K4's launches as designed (sync: one per shard a
   step; overlap: the interior and four strips per shard), the overlap
   plan's blocks overlapped on both axes with corners and no fallback;
   the eikonal solve at 4096 x 4096 (inner 4, (8, 128) tiles) on the
   (2, 2) mesh, synchronous: the unsharded solve's iterations, ``phi`` bit
   for bit, K5 once per shard an iteration; the Euler solver
   (``workloads.build_euler_solver``, 1024 x 512, 20 steps) unsharded, on
   (4,) over "gy" and on (2, 2) with ``overlap=True``, split and unsplit:
   states within rtol 1e-5, atol 1e-6 of the unsharded run, ``smax``
   equal, the mass drift printed.  Printed, not gated: ms per step of the
   three flux runs, the halo bytes copied per step, the device busy share
   of one profiled step, the eikonal solve's seconds both ways.  Then
   each of these again under ``regions=True`` with ``donate=False`` and
   ``True``: the state bit for bit the eager mesh run's (the Euler state
   within rtol 1e-5, atol 1e-6, ``smax`` equal), the same 745 eikonal
   iterations, one capture per piece (a flux or Euler step, the eikonal
   body) holding K4 and K5 as kernel nodes as often as the eager step
   launches them, zero captures in steady state and for a second
   executor, with ms per step, device ms and busy share printed.  The
   eager mesh runs' K4/K5 launches join the kernels line's;
3e. measured tuning on a mesh and the paper's examples, at the defaults:
   the flux graph at 4096 x 4096 on the (2, 2) mesh of the card under
   ``tune="auto"`` and an empty tuning cache (the candidates measured
   and proposed, the search's seconds and captures, the winner, ms per
   step of the heuristic and the tuned plan; the tuned state bit for bit
   the heuristic plan's unless a tile changed, then within the flux
   limit; a second construction loading the decision with zero
   measurements); ``examples/particles_torch.py`` at 2^24 particles a
   species for 100 steps (its closed-form check) and
   ``examples/euler2d_torch.py`` at 1024 x 512 for 20 steps with
   ``--devices 4 --px 2 --overlap`` against one shard (the state within
   rtol 1e-5, atol 1e-6; every printed smax and rho range equal); the
   tuning's and the particle example's wrapper calls are checked (twice
   a kernel call site a capture) and join the kernels line's.  The
   device memory at each phase's peak is printed;
3f. training (``train_phase``) — qwen3-8b at its published width cut to
   4 layers (bf16, AdamW, ``remat="full"``; 36 layers need ~98 GB of
   weights, gradients and moments): 5 steps on one repeated
   ``SyntheticLM`` batch of 2 x 2048 through ``launch/train.py``'s
   ``build_trainer``, the loss finite and falling, ms a step, tokens/s,
   peak memory and 6 N tokens over the step time at 989 TFLOP/s, K6
   twice a layer a step (forward and remat recompute; its backward is the
   plain version recomputed), one profiled step (its device time and
   K6's kernels in it; K6's backward a step: one call's kernels profiled
   alone at its shape times the calls), and K6's forward and backward
   timed alone at that shape;
   the gradient gate: the kernel route's gradients of one batch against
   ``use_kernel=False``'s within ``GRAD_REL_TOL`` per parameter, the
   projections into K6 (``wq``/``wk``/``wv``) and K7
   (``wx``/``wB``/``wC``/``wdt``) non-zero, and the kernel's output
   detached (what the route did before its ``autograd.Function``) outside
   the limit, for qwen3-8b and mamba2-130m (float32: its gradients at
   random init amplify one bf16 step of y_intra many times); then
   phi3.5-moe at its published width cut to 2 layers (bf16, remat,
   microbatches 2), 4 steps of 2 x 2048 under
   ``torch.use_deterministic_algorithms(True)`` through
   ``make_train_step`` with the local dispatch and with ``mesh=`` a (4,
   2) mesh of the card (the MoE all-to-all), the loss finite and
   falling, K6 twice a layer a microbatch a step, ms a step each way,
   and its gradient gate with the plain route replaying the kernel
   route's expert choices; then mamba2-130m at its
   published config, batch 8 x 2048, through the ``Supervisor`` with a
   ``CheckpointManager`` (a temporary directory, deleted) every 2 steps,
   8 steps under ``torch.use_deterministic_algorithms(True)``, clean and
   with ``Fault("supervisor.step", step=5)``: the faulted run restores
   step 4 and replays, every loss and the final parameters, moments and
   step bit for bit the clean run's, K7 twice a layer a step; each save's
   ms and bytes and the recovery's ms; a mamba2-130m step alone and the
   largest kernels of a profiled one (also of qwen3-8b's); the
   ``Prefetcher`` bringing the batches onto the card; ``examples/train_lm_torch.py --steps 50``;
   the serve launcher's ``--smoke --chaos`` (both archs) and ``--smoke
   --legacy`` in this process; then (f) the other archs' training
   (``TRAIN_ARCH_CASES``, each at every published width and cut in
   depth with one layer of each kind: gemma3-12b 6 of 48 layers,
   recurrentgemma-9b 3 of 38, qwen1.5-4b 4 of 40, chatglm3-6b 4 of 28,
   seamless-m4t-medium whole with its frames, llava-next-mistral-7b 4 of
   32 with 2048 patch positions, arctic-480b 1 of 35 under Adafactor
   with one microbatch), each after its byte reckoning
   (``train_reckoning``, under 80 GB) through ``build_trainer`` for
   ``TRAIN_ARCH_STEPS`` steps of 2 x 2048 (arctic-480b 1 x 2048) and
   one profiled step: the loss finite and falling, K6's launches exact
   (``k6_calls``: every attention call, the encoder's and the
   cross-attention's included, and again in the remat recompute), ms a
   step, tokens/s, peak memory, the 6 N share, K6's forward against its
   backward's device time (``k6_backward_share``), the largest kernels; the gradient gate on one row (seamless's encoder,
   decoder and cross-attention projections apart; the detached variant
   shown to take every K6 call and leave those projections no gradient;
   arctic-480b over every leaf but its experts' ``wi``/``wo``, replaying
   the expert choices); K6's forward and backward alone at each training
   shape; recurrentgemma-9b's RG-LRU scan launches forward and backward;
   and (g) the gradients of ``sum(out * r)`` of one recurrentgemma-9b
   "R" layer, one gemma3-12b "L" layer and one seamless-m4t-medium
   encoder layer with its frontend projection at published width, float32
   with TF32 off, on the card against the CPU within ``LAYER_GRAD_TOL``
   (``tools/chip_phases.py trainarchs`` runs (f) and (g) alone); the
   phase's seconds.  (a)'s, (f)'s, phi3.5-moe's and the supervised
   runs' K6/K7 launches join the kernels line's;
3i. explicit collectives (``parallel_phase``) on meshes of shards of
   the one card (``core/collectives.py``: copies and views on the
   card), every gate fatal: the MoE all-to-all (``make_moe_a2a``) on a
   (4, 2) ("data", "model") mesh of 8 shards, 4 x 2048 tokens bf16, at
   one phi3.5-moe layer's published widths (16 experts, d 4096, f 6400;
   2.5 GB of experts placed as views) and one arctic-480b layer's (128
   experts, d 7168, f 4864; 26.8 GB): at capacity 1.25 within the bf16
   limit (``A2A_TOL``) of ``moe_block`` on each data shard's tokens, at
   capacity 8 of ``moe_block`` over all of them, ``residual_tp`` both
   ways, the reference replaying the a2a's expert choices; the reverse
   exchange with the shard order reversed outside the limit;
   phi3.5-moe's gradients of x, the router, ``wi`` and ``wo`` within
   ``A2A_GRAD_TOL`` of the per-shard ``moe_block``'s; printed: the aux
   against the per-shard mean, pairs dropped, the bytes an all-to-all
   moves, ms against ``moe_block``.  phi3.5-moe cut to 4 layers at its
   published width, a prefill of 4 x 2048 tokens through ``moe_a2a``
   (``moe_a2a_for``): K6 once per layer, the last logits within
   ``LOGIT_TOL`` of the prefill of each row alone without the hook
   (replaying the hook's expert choices; printed free too), the reverse
   exchange reversed outside; its K6 launches join the kernels line's.
   Sequence parallelism on ("sp",) of 4: mamba2-130m's conv input (B 8,
   4 x 2048, 1792 channels) through ``seqpar_conv_halo`` and
   ``causal_conv1d`` bit for bit the unsharded conv; recurrentgemma-9b's
   RG-LRU width (B 4, 4 x 2048) through per-shard ``linear_scan`` and
   ``seqpar_scan_carry`` within float32 rtol 1e-5 of the unsharded scan,
   a carry without the decay product outside.  ``compressed_psum`` on
   ("data",) of 8 over a gradient tree shaped like mamba2-130m's
   parameters (float32, seeded per shard): 30 steps with error feedback,
   the time-averaged mean within 2e-2 of the true mean, the int32 sums
   equal to float64 sums; payload bytes and ms a call printed.  The
   phase's seconds and peak memory are printed;
4. times — per kernel (CUDA events around 30 calls back to back, the
   median of 5 such batches, after warm-up) beside
   its bound (bytes over 3.35 TB/s, or operations over the peak rate
   for their type: 67 TFLOP/s of float32 outside the tensor cores, 989
   TFLOP/s of bf16 on them for the bf16 inputs of K6 and K7), its plain
   version and, where one PyTorch call computes the same function, that
   call; the attention kernel also in bfloat16 at the three head-dim-256
   shapes (against SDPA under the first backend that takes the call: a
   band mask for a window); the flux kernel also in AoS, in bfloat16 and with its loads,
   shuffles and stores alone; the eikonal kernel also at its other timed
   tiles, in bfloat16, with its loads and stores alone (inner 0) and with
   every access scalar,
   the SSD kernel also by its profiler device time (at chunks 128 and
   256) and its wrapper's host time (``time_ms`` reads the host once a
   call's host work outlasts its device time), and in float32.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or without
the rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import contextlib
import fnmatch
import functools
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

# NVIDIA H100 SXM data sheet: device memory rate and float32 rate outside
# the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# ... and the bf16 dense rate of its tensor cores
BF16_TC_OPS_PER_S = 989e12

SAXPY_N, SAXPY_A, SAXPY_STEPS = 1 << 24, 1.75, 20
PARTICLE_N, PARTICLE_STEPS = 1 << 24, 100
FLUX_N, FLUX_STEPS, FLUX_LAM = 4096, 20, 0.1
# λx, λy of the flux kernel's parity: distinct, so that an x/y swap shows
FLUX_PARITY_LAM = (0.1, 0.05)
EIK_N, EIK_INNER, EIK_BLOCK, EIK_WARM = 4096, 4, (8, 128), 50
# phase 3d: the Euler solver's grid and steps (paper §8's shock-bubble at
# a size that keeps the phase short)
EULER_NX, EULER_NY, EULER_STEPS = 1024, 512, 20
# the NaN-ignoring max/min timed at the benchmark's views: the particle
# cells' ions' AoS v (records of 6 floats, the field at offset 3: a
# 6.44 GB span) and the eikonal cell's change (8192^2)
REDUCE_IONS_N, REDUCE_GRID_N = 1 << 28, 8192
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# eikonal, as (atol, rtol): float32 uncontracted, so equal to the plain
# version; bfloat16 a few bfloat16 steps at the fronts' magnitude (the
# kernel rounds its tile once per sweep, the plain version after every
# operation: one step apart at 4096^2 on the H100)
EIK_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 1.6e-2)}
# flux: float32 sums of ~90-op face fluxes in another order than the plain
# version; bfloat16: the kernel computes in float32 and rounds once, the
# plain version rounds after every operation
FLUX_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# operations of one FORCE face flux as the reference writes it
# (physics/euler.py force_flux): three physical fluxes of 13 each, 2 for
# the λ factors, 10 per component for the Lax-Friedrichs flux and the
# Richtmyer state, 2 per component to average.  The bound counts the
# unique faces once, whatever an implementation recomputes.
OPS_PER_FACE = 3 * 13 + 2 + 4 * 10 + 4 * 2
# per cell: lam * (F+ - F-) per dim and component, and the sum of the dims
OPS_PER_CELL = 2 * 4 * 2 + 4
# operations of one Godunov update with its source select in
# csrc/eikonal.cu, per cell and sweep
EIK_OPS_PER_CELL_SWEEP = 17
# the tuning phase: steps of the heuristic and of the tuned plan each, and
# the tuning cache it starts empty
TUNE_CHECK_STEPS = 100
TUNE_CACHE = os.path.join(REPO, "build", "tune-cache")
# LM serving: 8 requests, two of each prompt length, 4 batch slots
LM_PROMPTS = (2048, 2048, 1536, 1536, 1000, 1000, 517, 517)
# ragged traffic: every prompt length new
LM_RAGGED = (2048, 1800, 1536, 1280, 1000, 768, 517, 300)
LM_INTERLEAVE_STEPS = 12
LM_GEN, LM_SLOTS, LM_MAX_SEQ = 32, 4, 2112
# K6 at the qwen3-8b prefill shape (B, Hq, Hkv, S, D), K7 at mamba2-130m's
# (B, S, H, P, N, chunk)
ATTN_SHAPE = (1, 32, 8, 2048, 128)
# ... and at head dim 256, the prefill shapes (B, Hq, Hkv, S, D) and
# windows of gemma3-12b's local and global layers and recurrentgemma-9b's
# local layers (its window of 2048 equals causal at 2048 tokens)
ATTN_SHAPES_256 = {"gemma3-12b L": ((1, 16, 8, 2048, 256), 1024),
                   "gemma3-12b A": ((1, 16, 8, 2048, 256), None),
                   "recurrentgemma-9b L": ((1, 16, 1, 2048, 256), 2048)}
SSD_SHAPE = (1, 2048, 24, 64, 128, 128)
# ... and at the tile registry's largest chunk, which mamba2-130m's
# config takes with ssd_chunk=256
SSD_CHUNK_256 = 256
# K6/K7 against their plain versions, per output, as (atol, rtol).  Both
# sides load the same values, compute in float32 and round once, so the
# float32 limits cover sums in another order (H100 readings: K6 8.3e-7;
# K7 y_intra 5.6e-5, 128 terms of magnitude up to ~10 per output; K7
# chunk states 5.2e-6), and a bfloat16 output adds 2^-6 relative, two
# bfloat16 steps at the least, to its float32 atol (H100 readings: one
# step).  The chunk states are float32 in either dtype.
LM_KERNEL_TOL = {
    "flash_attention": {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2**-6)},
    "ssd_intra_chunk y_intra": {"float32": (2e-4, 2e-4),
                                "bfloat16": (2e-4, 2**-6)},
    "ssd_intra_chunk chunk states": {"float32": (2e-5, 2e-5),
                                     "bfloat16": (2e-5, 2e-5)}}
# last-position prefill logits, kernel route against plain route (bf16
# weights and activations; absolute, as max |difference|), set from the
# H100 readings 5.66e-2 (qwen3-8b) and 1.05e-1 (mamba2-130m, both routes
# rounding y_intra to bf16), 8.59e-2 (gemma3-12b) and 1.09e-1
# (recurrentgemma-9b); the wrong variants read 5.8, 2.9, 3.75 and 2.29
LOGIT_TOL = {"qwen3-8b": 0.25, "mamba2-130m": 0.25, "gemma3-12b": 0.25,
             "recurrentgemma-9b": 0.25, "qwen1.5-4b": 0.25,
             "chatglm3-6b": 0.25, "seamless-m4t-medium": 0.25,
             "llava-next-mistral-7b": 0.25, "phi3.5-moe": 0.25,
             "arctic-480b": 0.25}
# phase 3 serves these two at their published configs beside the two
# above, with the same checks, the ring check, and one request alone in
# place of the ragged, interleaved and captured-prefill measurements
LM_LOCAL_ARCHS = ("gemma3-12b", "recurrentgemma-9b")
# the ring check: a prompt, then RING_DECODE tokens teacher-forced through
# the decode caches, the last step's logits against one prefill over all
# of them (absolute, as max |difference|).  Each prompt is longer than
# its arch's window, so the ring holds it wrapped: with recurrentgemma's
# window of 2048 a 2048-token prompt would leave the no-wrap variant
# only the 16 decoded keys to lose (H100 reading: 0.125 against 0.117
# wrapped), a 3072-token one half the ring.  H100 readings: gemma3-12b
# 1.02e-1 (no wrap 2.60), recurrentgemma-9b 1.16e-1 (no wrap 0.581)
RING_PROMPT = {"gemma3-12b": 2048, "recurrentgemma-9b": 3072}
# phase 3g: qwen1.5-4b (QKV bias, MHA 20/20) and chatglm3-6b (GQA 32/2,
# half-dim interleaved RoPE) through the Batcher as the local-layer archs
# (one request alone, no ring); seamless-m4t-medium (encoder-decoder,
# head dim 64) and llava-next-mistral-7b (2048 patch positions before the
# text), which serve through the uniform loop: FRONTEND_ROWS rows of
# FRONTEND_PROMPT tokens, LM_GEN new ones, each row with ENC_LEN_SERVE
# frames or its patches; the decode check teacher-forces FRONTEND_DECODE
# tokens after a FRONTEND_PROMPT-token prefill against one prefill of all
# of them, within FRONTEND_DECODE_TOL (absolute, max |difference|)
LM_DENSE_ARCHS = ("qwen1.5-4b", "chatglm3-6b")
LM_FRONTEND_ARCHS = ("seamless-m4t-medium", "llava-next-mistral-7b")
FRONTEND_ROWS, FRONTEND_PROMPT, FRONTEND_DECODE = 4, 512, 16
FRONTEND_DECODE_TOL = {"seamless-m4t-medium": 0.25,
                       "llava-next-mistral-7b": 0.25}
# K6 at the new archs' prefill shapes (B, Hq, Hkv, Sq, Skv, D) and masks:
# the two dense archs at 2048 tokens, llava's 2048 patches + 512 text,
# seamless's encoder over 4096 frames, its decoder's self-attention at
# 512 tokens and its cross-attention from 512 tokens to 4096 frames, and
# arctic-480b's GQA group of 7 at 2048 tokens (phase 3h; phi3.5-moe's
# 32/8 is ATTN_SHAPE)
ATTN_SHAPES_3G = {
    "qwen1.5-4b": ((1, 20, 20, 2048, 2048, 128), True),
    "chatglm3-6b": ((1, 32, 2, 2048, 2048, 128), True),
    "llava-next-mistral-7b": ((1, 32, 8, 2560, 2560, 128), True),
    "seamless encoder": ((1, 16, 16, 4096, 4096, 64), False),
    "seamless decoder self": ((1, 16, 16, 512, 512, 64), True),
    "seamless cross": ((1, 16, 16, 512, 4096, 64), False),
    "arctic-480b": ((1, 56, 8, 2048, 2048, 128), True)}
# phase 3h: the MoE archs through the Batcher with phase 3g's requests and
# checks, at their published widths cut in depth to fit the card's 80 GB:
# phi3.5-moe 24 of 32 layers (1.31e9 parameters a layer, 16 experts:
# 62.8 GB of bf16 weights), arctic-480b 2 of 35 (1.36e10 a layer, 128
# experts and the dense residual: 27.2 GB each; 3 layers need 82.6 GB).
# Routing is discontinuous, so the kernel-vs-plain prefill logits are
# gated with the plain route replaying the kernel route's expert choices
LM_MOE_ARCHS = ("phi3.5-moe", "arctic-480b")
MOE_LAYERS = {"phi3.5-moe": 24, "arctic-480b": 2}
RING_DECODE = 16
RING_TOL = {"gemma3-12b": 0.25, "recurrentgemma-9b": 0.25}
# phase 3f, training: qwen3-8b at its published width cut to 4 layers
# (36 need ~98 GB for bf16 weights and gradients and float32 moments),
# 5 steps on one repeated batch of 2 x 2048; mamba2-130m at its published
# config, batch 8 x 2048, 8 steps under the Supervisor with a checkpoint
# every 2 steps and a step fault before step 5
TRAIN_QWEN_LAYERS, TRAIN_QWEN_BATCH, TRAIN_QWEN_STEPS = 4, 2, 5
TRAIN_SEQ = 2048
TRAIN_MAMBA_BATCH, TRAIN_MAMBA_STEPS = 8, 8
TRAIN_CKPT_EVERY, TRAIN_FAULT_STEP = 2, 5
# the gradient gate: per parameter, the kernel route's gradient against
# the plain route's as relative L2 difference (the two routes' forwards
# differ by the kernel's rounding against the plain version's), and the
# parameters whose gradient passes through the kernel alone.  qwen3-8b
# runs in bf16 (H100 reading: 9.4e-3).  mamba2-130m's gradients at random
# init amplify a difference of one bf16 step in y_intra to relative
# differences of 1-6 (H100 reading 6.2 in bf16; 1.75 on the CPU for a
# 0.4 % perturbation of the plain version), so its gate runs the
# published config in float32, where K7 and the plain version differ at
# ~1e-6 relative (the CPU emulation: ~2e-4 for a 1e-6 perturbation)
# phi3.5-moe at its published width cut to 2 layers (bf16, remat,
# microbatches 2: ~46 GB of weights, float32 moments and gradient sums),
# 4 steps on one repeated batch of 2 x 2048 under deterministic
# algorithms, with the local dispatch and with moe_a2a on a (4, 2) mesh
# of the card; its gradient gate replays the kernel route's expert
# choices on the plain route (K6's rounding alone flips some)
TRAIN_MOE_LAYERS, TRAIN_MOE_BATCH, TRAIN_MOE_STEPS = 2, 2, 4
# phase 3f(f): the other archs' training, each at every published width
# (d_model, heads, KV heads, head dim, d_ff, vocab, window, lru_width,
# experts, top-k, capacity factor), cut in depth to what the card's 80
# GB holds with one layer of each kind its pattern has; seamless at its
# full depth, arctic-480b in one layer with one microbatch (four would
# add float32 gradient sums of 56 GB).  Each case is (the config's cut,
# rows of TRAIN_SEQ tokens): arctic-480b takes one row, as its two rows
# peaked at 75.4 GiB alone on the H100 and phase 3f finds ~3.6 GiB still
# held by the phases before it, of the 79.2 GiB PyTorch can allocate
# there.  TRAIN_ARCH_STEPS steps each (``train_reckoning`` gives the
# bytes)
TRAIN_ARCH_CASES = {
    "gemma3-12b": ({"n_layers": 6}, 2),         # one group: 5 "L" + 1 "A"
    "recurrentgemma-9b": ({"n_layers": 3}, 2),  # "R", "R", "L"
    "qwen1.5-4b": ({"n_layers": 4}, 2),
    "chatglm3-6b": ({"n_layers": 4}, 2),
    "seamless-m4t-medium": ({}, 2),             # 12 encoder + 12 decoder
    "llava-next-mistral-7b": ({"n_layers": 4}, 2),  # 2048 patches + text
    "arctic-480b": ({"n_layers": 1, "microbatches": 1}, 1),
}
TRAIN_ARCH_STEPS = 3
# the device memory a reckoning must stay under (the data sheet's 80 GB)
CARD_BYTES = 80e9
# the gradient gate's limit (relative L2 per parameter), the parameters
# whose gradient passes through the kernel alone (fnmatch patterns over
# the port's names: seamless names the encoder's self-attention, the
# decoder's and the cross-attention's apart, so that one of them losing
# its gradient cannot hide behind another) and those it leaves out
# (arctic-480b: three gradient sets of its 26.8 GB of experts do not fit
# beside the weights; its gate covers attention, norms, router,
# embeddings and the dense residual).  H100 readings of the bf16 gates
# (the kernel route; the plain route against itself at half its chunks,
# the floor that rounding the attention output to bf16 sets): gemma3-12b
# 1.08e-2 (1.04e-2), recurrentgemma-9b 5.6e-3 (5.2e-3), qwen1.5-4b
# 9.6e-3 (9.6e-3), chatglm3-6b 7.9e-3 (8.1e-3), arctic-480b 7.9e-3
# (6.3e-3); every detached variant 1.0.  seamless-m4t-medium reads
# 9.60e-2 at its last decoder layers' wq/wk and its floor 9.66e-2 there
# (24 layers at random init: near-uniform attention over 2048 keys makes
# dL/dq a small difference of large terms), the encoder's and the
# cross-attention's 2.3-2.8e-2; llava-next-mistral-7b 2.24e-2 (2.03e-2),
# its loss down to 7e-3 on the repeated batch after four steps
GRAD_REL_TOL = {"qwen3-8b": 3e-2, "mamba2-130m": 2e-2, "phi3.5-moe": 3e-2,
                "gemma3-12b": 3e-2, "recurrentgemma-9b": 3e-2,
                "qwen1.5-4b": 3e-2, "chatglm3-6b": 3e-2,
                "seamless-m4t-medium": 0.2,
                "llava-next-mistral-7b": 5e-2, "arctic-480b": 3e-2}
_QKV = {"*.attn.wq", "*.attn.wk", "*.attn.wv"}
GRAD_NEEDED = {"qwen3-8b": _QKV,
               "mamba2-130m": {"*.wx", "*.wB", "*.wC", "*.wdt"},
               "phi3.5-moe": _QKV, "gemma3-12b": _QKV,
               "recurrentgemma-9b": _QKV, "qwen1.5-4b": _QKV,
               "chatglm3-6b": _QKV,
               "seamless-m4t-medium": {
                   f"{part}.{w}" for w in ("wq", "wk", "wv")
                   for part in ("encoder.*.attn", "groups.*.attn",
                                "groups.*.cross")},
               "llava-next-mistral-7b": _QKV, "arctic-480b": _QKV}
GRAD_GATE_EXCLUDES = {"arctic-480b": ("*.moe.wi", "*.moe.wo")}
# phase 3f(g): the backward of the layers that have no kernel, card
# against CPU in float32 (one row of LAYER_GRAD_SEQ tokens at the
# published widths), relative L2 per parameter
LAYER_GRAD_CASES = (("recurrentgemma-9b", "R"), ("gemma3-12b", "L"),
                    ("seamless-m4t-medium", "encoder"))
LAYER_GRAD_SEQ, LAYER_GRAD_TOL = 512, 1e-4
# phase 3i, explicit collectives on meshes of shards on the one card: the
# MoE all-to-all on a (4, 2) ("data", "model") mesh, 4 x 2048 tokens at
# the published widths of one phi3.5-moe layer (16 experts, d 4096, f
# 6400) and one arctic-480b layer (128 experts, d 7168, f 4864), bf16;
# its limit is bf16's (atol, rtol): the split d_ff sums rounded apart
# (each to bf16) against one rounding, ~1.5 bf16 steps; its gradients
# (relative L2 per tensor) against the per-shard moe_block's
PAR_MESH, PAR_TOKENS = (4, 2), 2048
A2A_TOL = (2e-2, 2e-2)
A2A_GRAD_TOL = 2e-2
A2A_CASES = ((1.25, False), (1.25, True), (8.0, False), (8.0, True))
# phi3.5-moe at its published width cut to 4 layers, 4 rows of 2048
# tokens prefilled through the hook
HOOK_LAYERS = 4
# sequence parallelism on ("sp",) of 4: mamba2-130m's conv input (B 8)
# and recurrentgemma-9b's RG-LRU width (B 4), 4 x 2048 tokens; the
# carry within float32 rtol 1e-5 (and 1e-5 of the largest state absolute)
SP_SHARDS, SP_SEQ, SP_CONV_BATCH, SP_SCAN_BATCH = 4, 2048, 8, 4
SP_CARRY_TOL = 1e-5
# compressed_psum on ("data",) of 8: a gradient tree shaped like
# mamba2-130m's parameters, float32, seeded per shard; 30 steps with
# error feedback, the time-averaged mean within 2e-2 of the true mean
# (the reference test's gate)
CPSUM_SHARDS, CPSUM_STEPS, CPSUM_TOL = 8, 30, 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, reps: int = 5, warmup: int = 3) -> float:
    """Device time of one call: ``iters`` calls back to back between one
    pair of CUDA events, divided by ``iters``; the median of ``reps`` such
    batches.  The host queues calls ahead of the card, so the host work of
    each call (checks, allocation, the launch itself) hides behind the
    kernels before it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(fn, iters: int = 30) -> float:
    """Host time of one call in microseconds: ``iters`` calls queued back
    to back on the host clock, without waiting for the card in between.
    ``time_ms`` records its start event before the first call's host work,
    so 1/``iters`` of this time falls inside each of its readings."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / iters


def run_steps(ex, state: dict, steps: int) -> tuple[dict, float]:
    """``steps`` passes of ``ex`` one at a time; returns the final state and
    the median host time of one step, each ended by a device synchronize."""
    import torch

    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ex.run(state, 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, statistics.median(times)


def outside(got, want, tol: float, rtol: float) -> tuple[float, int]:
    """The max absolute difference and the number of values where
    |got - want| > tol + rtol*|want| or got is not finite."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    diff = (g - w).abs()
    bad = int((~(diff <= tol + rtol * w.abs())).sum())
    return float(diff.max()), bad


def max_err(got, want, tol: float, what: str, rtol=None) -> float:
    """Max absolute difference; fails unless |got - want| <= tol + rtol*|want|
    (``rtol`` defaults to ``tol``) everywhere and every value is finite."""
    rtol = tol if rtol is None else rtol
    err, bad = outside(got, want, tol, rtol)
    log(f"parity {what}: max_abs_err={err:.3e} (atol {tol:g}, rtol "
        f"{rtol:g}, {bad} outside)")
    if bad:
        raise AssertionError(f"{what}: {bad} values outside tolerance")
    return err


def check_wrong(what: str, lim: tuple, want, variants: dict) -> None:
    """Each deliberately wrong variant against the plain result: fails
    unless every one has values outside the limit ``lim`` (atol, rtol)."""
    for name, got in variants.items():
        err, bad = outside(got, want, *lim)
        log(f"{what} bfloat16 wrong variant ({name}): max_abs_err="
            f"{err:.3e}, {bad} values outside the limit")
        if not bad:
            raise AssertionError(f"{what}: the bfloat16 limit does not see "
                                 f"{name}")


def attn_wrong_bf16(q, k, v, rounded: str, block: int = 64):
    """Causal attention in float32 with one deliberate bfloat16 rounding:
    ``rounded="accumulator"`` rounds the online softmax's output sum to q's
    dtype after each ``block`` keys; ``rounded="P"`` rounds each tile's
    probabilities once to bfloat16 before P·V (the usual flash-attention
    design, which K6 replaces by a hi/lo split of P)."""
    import torch

    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    k = k.float().repeat_interleave(group, dim=1)
    v = v.float().repeat_interleave(group, dim=1)
    qs = q.float() / D ** 0.5
    pos = torch.arange(S, device=q.device)
    m = torch.full((B, Hq, S, 1), -1e30, device=q.device)
    l = torch.zeros((B, Hq, S, 1), device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for j in range(0, S, block):
        s = qs @ k[:, :, j:j + block].transpose(-1, -2)
        seen = pos[:, None] >= pos[None, j:j + block]
        m_new = torch.maximum(m, s.masked_fill(~seen, -1e30).amax(
            -1, keepdim=True))
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        pv = p.bfloat16().float() if rounded == "P" else p
        acc = acc * alpha + pv @ v[:, :, j:j + block]
        if rounded == "accumulator":
            acc = acc.to(q.dtype).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l).to(q.dtype)


def ssd_chunk_terms(x, dt, A, Bm, C, chunk: int):
    """K7's float32 intermediates as the plain version forms them: dt
    (B, nc, H, L), cs = cumsum(dt A) (B, nc, H, L), the scores (C B^T) o
    decay (B, nc, H, L, L), x (B, nc, H, L, P) and B (B, nc, L, N)."""
    import torch

    B, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // chunk
    dtc = dt.reshape(B, nc, chunk, H).movedim(3, 2)
    cs = torch.cumsum(dtc * A[:, None], dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    decay = torch.exp(torch.where(tri, seg, 0.0)) * tri
    bc = Bm.float().reshape(B, nc, chunk, N)
    cb = torch.einsum("bcin,bcjn->bcij",
                      C.float().reshape(B, nc, chunk, N), bc)
    xh = x.float().reshape(B, nc, chunk, H, P).movedim(3, 2)
    return dtc, cs, cb[:, :, None] * decay, xh, bc


def ssd_bf16_sum(x, dt, A, Bm, C, chunk: int):
    """K7's ``y_intra`` with a wrong bfloat16 sum: the running sum over a
    chunk's positions rounded to x's dtype after each term, the terms in
    float32 as the plain version forms them."""
    import torch

    dtc, _, scores, xh, _ = ssd_chunk_terms(x, dt, A, Bm, C, chunk)
    dx = dtc[..., None] * xh                               # (B,nc,H,L,P)
    y = torch.zeros(xh.shape, dtype=x.dtype, device=x.device)
    for j in range(chunk):
        y = (y.float() + scores[..., j, None] * dx[..., j, None, :]).to(
            x.dtype)
    return y.movedim(2, 3).reshape(x.shape)


def ssd_rejected_bf16(x, dt, A, Bm, C, chunk: int, part: str):
    """K7's bf16 route as the designs it rejects compute it, in float32 on
    the card: ``part="y_intra"`` forms S' = (C B^T) o decay o dt and rounds
    it once to bfloat16 before S' x (the kernel issues S' as a bf16 hi/lo
    pair); ``part="chunk states"`` rounds the state weights w_j x_j once to
    bfloat16 before the product with B (the kernel issues two pieces)."""
    import torch

    dtc, cs, scores, xh, bc = ssd_chunk_terms(x, dt, A, Bm, C, chunk)
    if part == "y_intra":
        y = (scores * dtc[..., None, :]).bfloat16().float() @ xh
        return y.movedim(2, 3).reshape(x.shape).to(x.dtype)
    w = dtc * torch.exp(cs[..., -1:] - cs)                 # (B, nc, H, L)
    a = (xh * w[..., None]).bfloat16().float()
    return torch.einsum("bchjp,bcjn->bchpn", a, bc)


def device_time_by_kernel(fn,
                          warmup: int = 0) -> dict[str, tuple[float, int]]:
    """Run ``fn`` once under ``torch.profiler``; returns the device time in
    microseconds and the launch count of every kernel it ran, by name.
    ``warmup`` calls run first under the profiler's warm-up and are not
    counted: on the H100 the trace lost the first launches of a short
    call (the two K3 launches that open a particle step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=1)
                 if warmup else None) as prof:
        for _ in range(warmup):
            fn()
            torch.cuda.synchronize()
            prof.step()
        fn()
        torch.cuda.synchronize()
    # with a schedule, the profiler's own "ProfilerStep#" range also
    # carries the whole step's device time: it is no kernel
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")}


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_work(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
              itemsize: int, causal: bool = True, window=None,
              q_offset: int = 0) -> tuple[int, int]:
    """Bytes (q, k, v read once, the output written once) and operations
    (two products of 2 D operations per visible (query, key) pair) of one
    flash-attention call."""
    pairs = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(pos + 1, Skv) if causal else Skv
        lo = max(pos - window + 1, 0) if window else 0
        pairs += max(hi - lo, 0)
    nbytes = itemsize * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D)
    return nbytes, 4 * D * pairs * B * Hq


def ssd_work(B: int, S: int, H: int, P: int, N: int, L: int,
             itemsize: int) -> tuple[int, int]:
    """Bytes and operations of one intra-chunk SSD call: x, B, C in the
    storage type and dt in float32 read once, y written in the storage
    type and the float32 chunk states; C B^T and its product with dt x
    over the L (L + 1) / 2 pairs the causal decay keeps, and the chunk
    state (2 L P N), per (batch, chunk, head)."""
    nc = S // L
    nbytes = (itemsize * (2 * B * S * H * P + 2 * B * S * N)
              + 4 * B * S * H + 4 * H + 4 * B * nc * H * P * N)
    tri = L * (L + 1) // 2
    ops = B * nc * H * (2 * tri * N + 2 * tri * P + 2 * L * P * N)
    return nbytes, ops


def tune_graph(what: str, g, inputs: dict, limits: dict, card: str,
               zero_counts, read_counts, mesh=None,
               strict: bool = False) -> dict:
    """Construct ``Executor(g, tune="auto", tune_inputs=inputs)`` on the
    card (on ``mesh`` when given), at the executor's defaults: every
    candidate is timed as a captured graph, one capture each.  Then run
    the heuristic and the tuned plan ``TUNE_CHECK_STEPS`` steps each from
    ``inputs`` (and one more step of each under ``torch.profiler``, after
    the counts are read).  Fails unless every state value of the tuned
    plan equals the heuristic plan's within ``limits`` (state key -> max
    |difference|; 0 means bitwise; with ``strict``, bitwise unless the
    decision changed a tile) and a second construction loads the
    decision from the cache with zero measurements.  Returns the launch
    counts of the whole phase (search, both runs), the captures it made
    (each calls every wrapper of the graph twice: the warm-up and the
    capture) and the readings."""
    import torch

    from repro_torch.core import Executor
    from repro_torch.tuning import search as tune_search

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    tuned = Executor(g, mesh=mesh, tune="auto", tune_inputs=inputs)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    dec = tuned.plan.tuning
    if dec.source != "measured":
        raise AssertionError(f"tune {what}: decision from {dec.source}, "
                             f"expected a measured one (fresh cache)")
    log(f"tune {what}: {tuned.describe_tuning()}")
    base = Executor(g, mesh=mesh)       # the heuristic plan, at the defaults
    want, base_ms = run_steps(base, base.init_state(**inputs),
                              TUNE_CHECK_STEPS)
    got, tuned_ms = run_steps(tuned, tuned.init_state(**inputs),
                              TUNE_CHECK_STEPS)
    counts = read_counts()
    for key, lim in limits.items():
        if strict and not dec.tiles:
            lim = 0.0         # a change of layouts alone: bit for bit
        t = base.tensors.get(key)
        pairs = ([(f"{key}.{f}", tuned.read(got, t).field(f),
                   base.read(want, t).field(f)) for f in t.spec.names]
                 if t is not None and t.is_record
                 else [(key, got[key], want[key])])
        for name, a, b in pairs:
            same = torch.equal(a, b)
            err = float((a.float() - b.float()).abs().max())
            log(f"tune {what} {name}: tuned vs heuristic after "
                f"{TUNE_CHECK_STEPS} steps: bitwise equal {same}, max "
                f"|difference| {err:.3e} (limit {lim:g})")
            if not (same or err <= lim):
                raise AssertionError(f"tune {what}: {name} of the tuned "
                                     f"plan differs from the heuristic's")
    # the fields compared are views of the returned states, which the
    # runs below may move out (the executor refuses while a view lives)
    del pairs, a, b
    # where each plan's step goes: one more step of each under the
    # profiler (each donates its state: they are compared above)
    for name, ex, st, wall_ms in (("heuristic", base, want, base_ms),
                                  ("tuned", tuned, got, tuned_ms)):
        by_kernel = device_time_by_kernel(lambda: ex.run(st, 1), warmup=1)
        busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
        log(f"tune {what} {name} step: device busy {busy_ms:.4f} ms of "
            f"{wall_ms:.3f} ms wall per step ({card})")
        for kname, (us, n) in sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:8]:
            log(f"  {us / 1e3:.4f} ms, {n} launches: {kname[:100]}")
    measured = tune_search.STATS["measurements"]
    again = Executor(g, mesh=mesh, tune="auto",
                     tune_inputs=inputs).plan.tuning
    if again.source != "cache" or \
            tune_search.STATS["measurements"] != measured:
        raise AssertionError(f"tune {what}: the second construction came "
                             f"from {again.source} with "
                             f"{tune_search.STATS['measurements'] - measured}"
                             f" new measurements")
    # one capture a measured candidate (its first timed call; the losers'
    # entries go after the search), and one more for the heuristic plan
    # unless it won (then the tuned executor and ``base`` share its
    # entry; otherwise ``tuned`` shares the winner's)
    captures = dec.measured + (1 if dec.applied else 0)
    chosen = ", ".join(
        [f"{k}={v.name}" for k, v in sorted(dec.layouts.items())]
        + [f"{k}={v!r}" for k, v in sorted(dec.tiles.items())]) \
        or "the heuristic plan"
    log(f"tune {what}: search {search_s:.3f} s wall, {dec.proposed} "
        f"proposed / {dec.pruned} pruned / {dec.measured} measured, one "
        f"capture each; chose {chosen}; per step heuristic {base_ms:.3f} "
        f"ms, tuned {tuned_ms:.3f} ms (median of {TUNE_CHECK_STEPS}, both "
        f"at the defaults); the second construction loaded it from the "
        f"cache with 0 measurements; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated "
        f"({card})")
    return {"counts": counts, "captures": captures, "search_s": search_s,
            "base_ms": base_ms, "tuned_ms": tuned_ms, "decision": dec}


def serve_lm(arch: str, card: str, zero_counts, read_counts) -> dict:
    """Serve ``arch`` at its published config through ``Batcher`` ->
    ``Executor`` on the card, at the defaults (the decode step captured
    once, the prefills eager); check launches, the serve launcher's smoke
    checks (the decode captured once; a fresh worker ``Batcher`` serving
    the same requests with no new decode capture and equal streams),
    token streams against ``per_request_generate`` and the kernel route's
    prefill logits against the plain route's.  Measures tokens/s with
    the decode capture and without it (the worker); two batchers of one
    signature stepped in turn; ragged traffic of 8 new lengths with
    eager prefills and with one capture per length; and each captured
    prefill's first call and memory, with the repeated lengths served on
    the replays.  An arch with local layers (gemma3-12b,
    recurrentgemma-9b) skips those four measurements and adds the ring
    check and one request served alone; qwen1.5-4b and chatglm3-6b
    (``LM_DENSE_ARCHS``) skip them and add the request alone; the MoE
    archs (``LM_MOE_ARCHS``), cut in depth to ``MOE_LAYERS``, add the
    request alone and take ``moe_checks`` in place of ``serve_checks``.
    Returns the launch counts of the batcher's run and its
    measurements."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models.lm import init_lm
    from repro_torch.runtime.batcher import Batcher

    dev = torch.device("cuda")
    cfg = configs.get(arch)
    if arch in MOE_LAYERS:
        log(f"{arch}: reduced: {MOE_LAYERS[arch]} of {cfg.n_layers} layers "
            f"(the published width; the depth cut to fit the card)")
        cfg = cfg.with_(n_layers=MOE_LAYERS[arch])
    kinds = [k for _ in range(cfg.layer_groups()[0])
             for k in cfg.layer_groups()[1]] + list(cfg.layer_groups()[2])
    local = "L" in kinds
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters in {cfg.param_dtype} made on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LM_PROMPTS]

    # the main path: the batcher as serve.py builds it (prefill-ahead on),
    # timed from outside; the decode step captured on its first call, one
    # eager prefill per request
    batcher = Batcher(cfg, params, batch=LM_SLOTS, max_seq=LM_MAX_SEQ,
                      log=log)
    if not (batcher.executor.regions and batcher.executor.donate):
        raise AssertionError(f"{arch}: the batcher's decode executor is not "
                             f"at regions=True, donate=True")
    reqs = [batcher.submit(p, max_new_tokens=LM_GEN) for p in prompts]
    toks, wall, step_ms = served(batcher, reqs, zero_counts)
    counts = read_counts()
    log(f"main path {arch}: {len(reqs)} requests, {batcher.steps} decode "
        f"steps, {toks} tokens in {wall:.3f} s = {toks / wall:.1f} "
        f"tokens/s; decode {step_ms:.3f} ms per step (median gap between "
        f"harvests, 4 slots); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card})")
    # each request's prefill runs eagerly: K6/K7 once per layer each
    lengths = sorted(set(LM_PROMPTS), reverse=True)
    expect = {"flash_attention": (kinds.count("A") + kinds.count("L"))
              * len(reqs),
              "ssd_intra_chunk": kinds.count("M") * len(reqs)}
    stats = batcher.cache_stats()
    if stats["decode"]["trace_events"] != 1 or sorted(stats["prefill"]) \
            != sorted(lengths) or any(
                ex.regions for _, ex in batcher._prefill.values()):
        raise AssertionError(f"{arch}: captures {json.dumps(stats)}; "
                             f"expected the decode step once and eager "
                             f"prefills")
    log(f"[smoke] {arch}: decode captured once across {batcher.steps} "
        f"steps; the {len(lengths)} prompt lengths' prefills eager")

    # the launcher's fresh-worker check, which also times the serving
    # without the decode capture: a new Batcher over the same weights
    # shares the decode entry (its plan signature is the first's)
    worker = Batcher(cfg, params, batch=LM_SLOTS, max_seq=LM_MAX_SEQ,
                     log=log)
    if worker.executor.plan.signature != batcher.executor.plan.signature:
        raise AssertionError(f"{arch}: the worker's decode plan differs")
    decode_caps = batcher.executor.cache_stats()["trace_events"]
    wreqs = [worker.submit(p, max_new_tokens=LM_GEN) for p in prompts]
    warm_tok, warm_wall, _ = served(worker, wreqs, zero_counts)
    new_caps = worker.executor.cache_stats()["trace_events"] - decode_caps
    if new_caps or [r.generated for r in wreqs] != \
            [r.generated for r in reqs]:
        raise AssertionError(f"{arch}: the fresh worker made {new_caps} "
                             f"decode captures, or its streams differ")
    log(f"[smoke] {arch}: a fresh worker served the {len(wreqs)} requests "
        f"with 0 new decode captures and equal streams: {warm_tok} tokens "
        f"in {warm_wall:.3f} s = {warm_tok / warm_wall:.1f} tokens/s "
        f"without the decode capture; {toks / wall:.1f} tokens/s with it "
        f"(the batcher's run) ({card})")

    extra = {}
    if local or arch in LM_DENSE_ARCHS + LM_MOE_ARCHS:
        del worker, wreqs
        extra["batch1"] = batch_one(arch, card, cfg, params, prompts[0],
                                    zero_counts)
    else:
        extra = serve_measurements(arch, card, cfg, params, batcher, worker,
                                   prompts, reqs, rng, zero_counts)
        del worker, wreqs
        log(f"repeated {arch}: the {len(prompts)} requests on captured "
            f"prefills, every length captured before: "
            f"{extra['captured_tok_s']:.1f} tokens/s; on eager prefills "
            f"{warm_tok / warm_wall:.1f} ({card})")
    # prefill ms per request: a separate pass through the batcher's own
    # (eager) prefill executors, synchronised on both sides
    prefill_ms = []
    for prompt in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        batcher._prefill_state(prompt)
        torch.cuda.synchronize()
        prefill_ms.append((len(prompt), (time.perf_counter() - t) * 1e3))
        log(f"  prefill {arch} {len(prompt)} tokens: {prefill_ms[-1][1]:.3f}"
            f" ms ({card})")
    del batcher
    checks = moe_checks if arch in LM_MOE_ARCHS else serve_checks
    return checks(arch, card, cfg, params, prompts, reqs, kinds, counts,
                  expect, extra, dict(wall=wall, tok_s=toks / wall,
                                      warm_tok_s=warm_tok / warm_wall,
                                      step_ms=step_ms,
                                      prefill_ms=prefill_ms))


def serve_measurements(arch: str, card: str, cfg, params, batcher, worker,
                       prompts, reqs, rng, zero_counts) -> dict:
    """Phase 3's measurements of qwen3-8b and mamba2-130m beside the main
    path: two batchers of one signature stepped in turn, ragged traffic
    of 8 new lengths with eager prefills and with one capture per length,
    and each captured prefill's first call and memory, with the repeated
    lengths served on the replays (their streams those of ``reqs``)."""
    import numpy as np
    import torch

    from repro_torch.runtime.batcher import Batcher

    # two live batchers of one signature stepped in turn: each step moves
    # the other's returned state out onto a copy and copies its own in
    inter = interleaved(arch, card, batcher, worker, prompts, reqs)
    lengths = sorted(set(LM_PROMPTS), reverse=True)

    # ragged traffic, every prompt length new: the batcher's eager
    # prefills against one capture per length
    ragged = {}
    rprompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in LM_RAGGED]
    for mode, make in (("eager", Batcher), ("captured", captured_prefills())):
        rb = make(cfg, params, batch=LM_SLOTS, max_seq=LM_MAX_SEQ, log=log)
        rreqs = [rb.submit(p, max_new_tokens=LM_GEN) for p in rprompts]
        rtok, rwall, _ = served(rb, rreqs, zero_counts)
        ragged[mode] = {"tok_s": rtok / rwall,
                        "streams": [r.generated for r in rreqs],
                        "captures": sum(
                            ex.cache_stats()["trace_events"]
                            for _, ex in rb._prefill.values() if ex.regions)}
        log(f"ragged {arch} {mode} prefills: {len(rreqs)} requests of "
            f"{len(set(LM_RAGGED))} distinct lengths, {rtok} tokens in "
            f"{rwall:.3f} s = {rtok / rwall:.1f} tokens/s; "
            f"{ragged[mode]['captures']} prefill captures ({card})")
        del rb, rreqs
        gc.collect()
    if ragged["captured"]["streams"] != ragged["eager"]["streams"] or \
            ragged["captured"]["captures"] != len(set(LM_RAGGED)):
        raise AssertionError(f"ragged {arch}: captured prefills gave other "
                             f"streams, or not one capture per length")

    # repeated lengths with captured prefills: each length's capture alone
    # (first call, replay, memory), then the 8 requests on the replays
    capb = captured_prefills()(cfg, params, batch=LM_SLOTS,
                               max_seq=LM_MAX_SEQ, log=log)
    captures = {}
    for n in lengths:
        prompt = next(p for p in prompts if len(p) == n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t = time.perf_counter()
        pst = capb._prefill_state(prompt)[2]
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() - held
        kept = torch.cuda.memory_allocated() - held
        del pst
        torch.cuda.synchronize()
        t = time.perf_counter()
        capb._prefill_state(prompt)
        torch.cuda.synchronize()
        captures[n] = {"first_ms": first_ms,
                       "replay_ms": (time.perf_counter() - t) * 1e3,
                       "peak_gib": peak / 2**30, "kept_gib": kept / 2**30}
        log(f"  prefill capture {arch} {n} tokens: first call "
            f"{first_ms:.1f} ms, a replay {captures[n]['replay_ms']:.3f} "
            f"ms; {peak / 2**30:.3f} GiB above the memory before it at "
            f"its peak, {kept / 2**30:.3f} GiB kept by the entry ({card})")
    creqs = [capb.submit(p, max_new_tokens=LM_GEN) for p in prompts]
    cap_tok, cap_wall, _ = served(capb, creqs, zero_counts)
    if [r.generated for r in creqs] != [r.generated for r in reqs]:
        raise AssertionError(f"{arch}: captured prefills gave other "
                             f"streams")
    del capb, creqs
    gc.collect()
    return {"captures": captures, "captured_tok_s": cap_tok / cap_wall,
            "ragged": {k: v["tok_s"] for k, v in ragged.items()},
            "interleaved": inter}


def per_request_generate(cfg, params, tokens, gen: int, max_seq: int):
    """The ``Batcher``'s semantics on a uniform batch, the reference for
    its streams: each row of ``tokens`` (B, S) prefilled on its own (a
    routed arch buckets each request's tokens alone, and the prefill's
    products run at the batcher's shapes, which the card's libraries may
    sum in another order than a batched prefill's), the caches stacked
    along the batch axis, then greedy decode of the whole batch at one
    position.  Returns ``((B, gen) tokens, prefill s, decode s)``."""
    import torch

    from repro_torch.core import Layout
    from repro_torch.launch import steps
    from repro_torch.models.lm import prefill

    dev = next(params.parameters()).device
    tokens = torch.as_tensor(tokens).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [prefill(params, {"tokens": tokens[b:b + 1]}, cfg,
                    max_seq=max_seq) for b in range(tokens.shape[0])]
    kv_axis = 1 if cfg.kv_layout is Layout.SOA else 0

    def cat(xs):
        if isinstance(xs[0], tuple):    # a Mamba or RG-LRU layer's pair
            return tuple(torch.cat(list(z)) for z in zip(*xs))
        return torch.cat(xs, dim=kv_axis)

    parts = [c for _, c in rows]
    caches = {"groups": [{k: cat([p["groups"][g][k] for p in parts])
                          for k in grp}
                         for g, grp in enumerate(parts[0]["groups"])],
              "tail": [cat([p["tail"][i] for p in parts])
                       for i in range(len(parts[0]["tail"]))],
              "pos": parts[0]["pos"]}
    logits = torch.cat([lg for lg, _ in rows])
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    step = steps.make_decode_step(cfg)
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [toks]
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, caches = step(params, caches, toks)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(toks)
    out = torch.stack(out, dim=1).cpu().numpy()
    return out, t_prefill, time.perf_counter() - t1


def serve_checks(arch: str, card: str, cfg, params, prompts, reqs, kinds,
                 counts, expect, extra: dict, run: dict) -> dict:
    """The rest of phase 3 for ``arch``: the batcher's streams (``reqs``)
    against ``per_request_generate``'s, the kernel route's prefill logits
    against the plain route's (and a wrong variant outside the limit), the
    ring check where the arch has local layers, and where a prefill's and
    a decode step's time goes at batch 1.  Returns the phase's record."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import attention as model_attention
    from repro_torch.models.lm import prefill

    dev = torch.device("cuda")
    # the per-request loop on each equal-length pair, repeated to the
    # batcher's 4 slots so that both decode at one batch width
    for i in range(0, len(prompts), 2):
        rows = np.stack([prompts[i], prompts[i + 1]] * (LM_SLOTS // 2))
        gen, t_pre, t_dec = per_request_generate(
            cfg, params, torch.from_numpy(rows), LM_GEN, LM_MAX_SEQ)
        for j in (0, 1):
            if reqs[i + j].generated != gen[j].tolist():
                raise AssertionError(
                    f"{arch}: request {i + j} ({len(prompts[i + j])} "
                    f"tokens) streams {reqs[i + j].generated} from the "
                    f"batcher, {gen[j].tolist()} from the per-request "
                    f"loop")
        log(f"{arch} streams of the {len(prompts[i])}-token pair equal "
            f"the per-request loop's ({LM_GEN} tokens each; its prefill "
            f"{t_pre * 1e3:.1f} ms for 4 rows, decode "
            f"{t_dec / (LM_GEN - 1) * 1e3:.3f} ms per step)")

    # the kernel route's last-position logits against the plain route's
    tokens = torch.from_numpy(prompts[0][None]).to(dev)

    def run_prefill(use_kernel=True):
        return prefill(params, {"tokens": tokens}, cfg,
                       max_seq=tokens.shape[1] + 1, use_kernel=use_kernel)

    def logits(use_kernel=True):
        return run_prefill(use_kernel)[0].float()

    got, want = logits(), logits(use_kernel=False)
    if tuple(got.shape) != (1, cfg.padded_vocab()) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{arch}: prefill logits of shape "
                             f"{tuple(got.shape)}, or not finite")
    err = float((got - want).abs().max())
    same = int(got.argmax()) == int(want.argmax())
    log(f"{arch} prefill logits ({len(prompts[0])} tokens), kernel route "
        f"vs plain route: max |difference| {err:.4e} (limit "
        f"{LOGIT_TOL[arch]:g}, plain logits max |x| "
        f"{float(want.abs().max()):.3f}); argmax equal: {same}")
    if not err <= LOGIT_TOL[arch]:
        raise AssertionError(f"{arch}: prefill logits outside the limit")
    if expect["flash_attention"]:
        # the local layers without their window where the prompt is
        # longer than it; else (qwen3-8b; recurrentgemma-9b, whose window
        # of 2048 is causal at 2048 tokens) without the causal mask
        drop = ({"window": None} if "L" in kinds
                and cfg.window < tokens.shape[1] else {"causal": False})
        what = ("the local layers without their window" if "window" in drop
                else "attention without its causal mask")
        real = model_attention.flash_attention_fn
        model_attention.flash_attention_fn = \
            lambda *a, **kw: real(*a, **{**kw, **drop})
        try:
            wrong = logits()
        finally:
            model_attention.flash_attention_fn = real
    else:
        what = "SSD without the chunk states"
        real = ssd_ops.SsdIntraChunkFn

        class NoStates:
            @staticmethod
            def apply(*a):
                y, st = real.apply(*a)
                return y, torch.zeros_like(st)

        ssd_ops.SsdIntraChunkFn = NoStates
        try:
            wrong = logits()
        finally:
            ssd_ops.SsdIntraChunkFn = real
    werr = float((wrong - want).abs().max())
    log(f"{arch} wrong variant ({what}): max |difference| {werr:.4e} "
        f"against the plain route (limit {LOGIT_TOL[arch]:g})")
    if not werr > LOGIT_TOL[arch]:
        raise AssertionError(f"{arch}: the logits limit does not see "
                             f"{what}")
    ring = ring_check(arch, card, cfg, params) if "L" in kinds else None
    busy = busy_profile(arch, card, cfg, params, run_prefill,
                        got.argmax(dim=-1).to(torch.int32), len(prompts[0]))
    return {**run, **extra, "counts": counts, "expect": expect,
            "logit_err": err, "wrong_err": werr, "ring": ring, "busy": busy}


def busy_profile(arch: str, card: str, cfg, params, run_prefill, nxt,
                 n_tokens: int) -> dict:
    """Where the time goes: one prefill (``run_prefill()`` -> (logits,
    caches)) and one decode step of ``nxt`` after it (batch 1), the host
    clock around each, then the device's kernels under the profiler.
    Returns {what: (wall ms, device ms)}."""
    import torch

    from repro_torch.models.lm import decode_step

    _, caches = run_prefill()
    busy = {}
    for what, fn in (("prefill", run_prefill),
                     ("decode step", lambda: decode_step(params, caches,
                                                         nxt, cfg))):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        by_kernel = device_time_by_kernel(fn)
        dev_ms = sum(us for us, _ in by_kernel.values()) / 1e3
        wall_ms = statistics.median(walls)
        busy[what] = (wall_ms, dev_ms)
        log(f"{arch} {what} (batch 1, {n_tokens} tokens): wall "
            f"{wall_ms:.3f} ms (median of 3), device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f} %), "
            f"{sum(n for _, n in by_kernel.values())} kernel launches "
            f"({card})")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        for name, (us, count) in top:
            log(f"  {us / 1e3:.4f} ms, {count} launches: {name[:90]}")
    return busy


def moe_checks(arch: str, card: str, cfg, params, prompts, reqs, kinds,
               counts, expect, extra: dict, run: dict) -> dict:
    """Phase 3h's checks of an MoE arch after its batcher's run: the
    (token, k) pairs each request's prefill drops (``_dispatch_slots``
    wrapped here); the batcher's streams (``reqs``) against
    ``per_request_generate`` on each request, repeated to the batcher's
    4 slots so both decode at one width (equal, no tolerance; a
    difference prints its first position and the top-2 logit gap there);
    the kernel route's prefill logits against the plain route's with the
    plain route replaying the kernel route's expert choices (``_top_k``
    wrapped here), within ``LOGIT_TOL``, also printed without the replay
    with the count of (token, layer) choices that differ; the wrong
    variants outside the limit (attention without its causal mask; top-1
    routing for phi3.5-moe; arctic without its dense residual); then
    ``busy_profile``.  Returns the phase's record."""
    import numpy as np
    import torch

    from repro_torch.models import attention as model_attention
    from repro_torch.models import moe
    from repro_torch.models.lm import prefill

    dev = torch.device("cuda")

    def tokens_of(ids):
        return torch.from_numpy(np.asarray(ids, np.int32)[None]).to(dev)

    # the pairs each request's prefill drops, layer by layer
    drops = []
    for prompt in prompts:
        with dropped_pairs() as row:
            prefill(params, {"tokens": tokens_of(prompt)}, cfg,
                    max_seq=len(prompt) + 1)
        drops.append([int(d) for d in row])
    for prompt, row in zip(prompts, drops):
        cap = moe.moe_capacity(len(prompt), cfg.n_experts, cfg.top_k,
                               cfg.capacity_factor)
        log(f"{arch} prefill of {len(prompt)} tokens: {sum(row)} of "
            f"{len(prompt) * cfg.top_k * len(row)} (token, k) pairs dropped "
            f"over {len(row)} layers (capacity {cap} an expert; per layer "
            f"{min(row)}-{max(row)})")

    # the per-request loop on each request, 4 rows of it (each row
    # prefilled alone, as the batcher does)
    for i, prompt in enumerate(prompts):
        rows = np.stack([prompt] * LM_SLOTS)
        gen, t_pre, t_dec = per_request_generate(
            cfg, params, torch.from_numpy(rows), LM_GEN, LM_MAX_SEQ)
        want = reqs[i].generated
        for row in gen:
            if row.tolist() == want:
                continue
            pos = next(j for j, (a, b) in enumerate(zip(row, want))
                       if a != b)
            top2 = prefill(params, {"tokens": tokens_of(
                list(prompt) + want[:pos])}, cfg)[0].float().topk(2).values
            log(f"{arch}: request {i} ({len(prompt)} tokens) first differs "
                f"at generated position {pos}: batcher {want[pos]}, "
                f"per-request loop {int(row[pos])}; top-2 logit gap there "
                f"{float(top2[0, 0] - top2[0, 1]):.4e}")
            raise AssertionError(f"{arch}: request {i}'s stream differs from "
                                 f"the per-request loop's")
        log(f"{arch} stream of request {i} ({len(prompt)} tokens) equals "
            f"the per-request loop's ({LM_SLOTS} rows; its prefill "
            f"{t_pre * 1e3:.1f} ms, decode "
            f"{t_dec / (LM_GEN - 1) * 1e3:.3f} ms per step)")

    # the kernel route against the plain route, the plain route replaying
    # the kernel route's expert choices
    tokens = tokens_of(prompts[0])

    def logits(use_kernel=True, replay=None, c=cfg):
        with expert_choices(replay=replay) as chosen:
            out = prefill(params, {"tokens": tokens}, c,
                          max_seq=tokens.shape[1] + 1,
                          use_kernel=use_kernel)[0].float()
        return out, chosen

    got, kernel_route = logits()
    want, _ = logits(use_kernel=False, replay=kernel_route)
    free, plain_route = logits(use_kernel=False)
    if tuple(got.shape) != (1, cfg.padded_vocab()) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{arch}: prefill logits of shape "
                             f"{tuple(got.shape)}, or not finite")
    err = float((got - want).abs().max())
    free_err = float((got - free).abs().max())
    differ = sum(int((a != b).any(dim=-1).sum())
                 for a, b in zip(kernel_route, plain_route))
    log(f"{arch} prefill logits ({tokens.shape[1]} tokens), kernel route vs "
        f"plain route replaying its expert choices: max |difference| "
        f"{err:.4e} (limit {LOGIT_TOL[arch]:g}, plain logits max |x| "
        f"{float(want.abs().max()):.3f}); argmax equal: "
        f"{int(got.argmax()) == int(want.argmax())}; without the replay "
        f"{free_err:.4e}, {differ} of {tokens.shape[1] * len(kernel_route)} "
        f"(token, layer) choices differ between the routes")
    if not err <= LOGIT_TOL[arch]:
        raise AssertionError(f"{arch}: prefill logits outside the limit")
    real = model_attention.flash_attention_fn
    variants = {"attention without its causal mask": None}
    if arch == "phi3.5-moe":
        variants["top-1 routing"] = cfg.with_(top_k=1)
    if cfg.dense_residual:
        variants["no dense residual"] = cfg.with_(dense_residual=False)
    wrong = {}
    for what, c in variants.items():
        if c is None:
            model_attention.flash_attention_fn = \
                lambda *a, **kw: real(*a, **{**kw, "causal": False})
        try:
            bad, _ = logits(c=c or cfg)
        finally:
            model_attention.flash_attention_fn = real
        wrong[what] = float((bad - want).abs().max())
        log(f"{arch} wrong variant ({what}): max |difference| "
            f"{wrong[what]:.4e} against the plain route (limit "
            f"{LOGIT_TOL[arch]:g})")
        if not wrong[what] > LOGIT_TOL[arch]:
            raise AssertionError(f"{arch}: the logits limit does not see "
                                 f"{what}")
    busy = busy_profile(arch, card, cfg, params,
                        lambda: prefill(params, {"tokens": tokens}, cfg,
                                        max_seq=tokens.shape[1] + 1),
                        got.argmax(dim=-1).to(torch.int32),
                        tokens.shape[1])
    return {**run, **extra, "counts": counts, "expect": expect,
            "logit_err": err, "free_err": free_err, "differ": differ,
            "wrong": wrong, "wrong_err": min(wrong.values()),
            "drops": drops, "ring": None, "busy": busy}


def batch_one(arch: str, card: str, cfg, params, prompt,
              zero_counts) -> dict:
    """One request of ``prompt`` through a one-slot ``Batcher`` at the
    defaults (its decode captured): tokens/s, decode ms per step and its
    bound (the weights read once a step at the memory rate)."""
    import torch

    from repro_torch.runtime.batcher import Batcher

    b = Batcher(cfg, params, batch=1, max_seq=LM_MAX_SEQ, log=log)
    req = b.submit(prompt, max_new_tokens=LM_GEN)
    b.run()                       # the capture, then a second run timed
    req = b.submit(prompt, max_new_tokens=LM_GEN)
    toks, wall, step_ms = served(b, [req], zero_counts)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    bound_ms = weights / HBM_BYTES_PER_S * 1e3
    log(f"batch 1 {arch}: one {len(prompt)}-token request, {toks} tokens "
        f"in {wall:.3f} s = {toks / wall:.1f} tokens/s; decode "
        f"{step_ms:.3f} ms per step (captured), bound {bound_ms:.3f} ms "
        f"({weights} bytes of weights at 3.35 TB/s) ({card})")
    del b, req
    return {"tok_s": toks / wall, "step_ms": step_ms, "bound_ms": bound_ms}


def ring_check(arch: str, card: str, cfg, params) -> dict:
    """The ring after it wraps: a prompt of ``RING_PROMPT[arch]`` tokens
    prefilled (longer than the window: each local layer's ring of
    ``min(window, max_seq)`` slots holds its last positions wrapped),
    then ``RING_DECODE`` tokens teacher-forced through the decode caches;
    the last step's logits against the last-position logits of one
    prefill over all the tokens, within ``RING_TOL``, and the decode with
    each slot's position taken as its index (no wrap) outside it."""
    import numpy as np
    import torch

    from repro_torch.models import blocks
    from repro_torch.models.lm import decode_step, prefill

    dev = torch.device("cuda")
    prompt = RING_PROMPT[arch]
    n = prompt + RING_DECODE
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)

    def decoded():
        _, caches = prefill(params, {"tokens": toks[:, :prompt]}, cfg,
                            max_seq=n)
        for t in range(prompt, n):
            logits, caches = decode_step(params, caches, toks[:, t], cfg)
        return logits.float()

    want = prefill(params, {"tokens": toks}, cfg, max_seq=n)[0].float()
    got = decoded()
    err = float((got - want).abs().max())
    real = blocks._ring_kpos
    blocks._ring_kpos = lambda pos, W: torch.arange(
        W, dtype=torch.int32, device=pos.device).expand(*pos.shape, W)
    try:
        wrong = decoded()
    finally:
        blocks._ring_kpos = real
    werr = float((wrong - want).abs().max())
    log(f"{arch} ring check ({prompt} tokens prefilled, "
        f"{RING_DECODE} decoded through the ring of "
        f"{min(cfg.window, n)} slots): last logits against one prefill of "
        f"{n} tokens max |difference| {err:.4e} (limit {RING_TOL[arch]:g}, "
        f"max |x| {float(want.abs().max()):.3f}); argmax equal: "
        f"{int(got.argmax()) == int(want.argmax())}; wrong variant (each "
        f"slot's position its index, no wrap) {werr:.4e} ({card})")
    if not (torch.isfinite(got).all() and err <= RING_TOL[arch]):
        raise AssertionError(f"{arch}: the ring check is outside its limit")
    if not werr > RING_TOL[arch]:
        raise AssertionError(f"{arch}: the ring limit does not see a ring "
                             f"that does not wrap")
    return {"err": err, "wrong_err": werr}


def local_attention_parity() -> float:
    """K6 at head dim 256 (``ATTN_SHAPES_256``, gemma3-12b's and
    recurrentgemma-9b's prefills) against ``mha_ref`` on the same inputs,
    float32 and bfloat16, within ``LM_KERNEL_TOL``; at gemma3-12b's local
    shape the kernel run without its window must fall outside the limit.
    Returns the largest float32 difference."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ref import mha_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    worst = 0.0
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        lim = LM_KERNEL_TOL["flash_attention"][dname]
        for what, ((B, Hq, Hkv, S, D), window) in ATTN_SHAPES_256.items():
            q, k, v = (torch.randn(B, h, S, D, generator=gen,
                                   device=dev).to(dt)
                       for h in (Hq, Hkv, Hkv))
            want = mha_ref(q, k, v, window=window)
            e = max_err(flash_attention_cuda(q, k, v, window=window), want,
                        lim[0], f"flash_attention {dname} {what} "
                                f"{(B, Hq, Hkv, S, D)} window {window}",
                        rtol=lim[1])
            if dname == "float32":
                worst = max(worst, e)
            if window is not None and window < S:
                err, bad = outside(flash_attention_cuda(q, k, v), want,
                                   *lim)
                log(f"flash_attention {dname} {what} wrong variant (the "
                    f"kernel without its window): max_abs_err={err:.3e}, "
                    f"{bad} values outside the limit")
                if not bad:
                    raise AssertionError(f"flash_attention {what}: the limit "
                                         f"does not see a dropped window")
            del q, k, v, want
    torch.cuda.empty_cache()
    return worst


def sdpa_ms(q, k, v, window, causal: bool = True) -> tuple[float, str]:
    """``scaled_dot_product_attention`` on K6's inputs (causal, no mask
    with ``causal=False``, or a band mask of ``window`` keys): its time by
    ``time_ms`` under the first backend, in PyTorch's order of
    preference, that takes the call, and that backend's name."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S = q.shape[2]
    if not causal:
        kw = {}
    elif window is None:
        kw = {"is_causal": True}
    else:
        i = torch.arange(S, device=q.device)
        d = i[:, None] - i[None, :]
        kw = {"attn_mask": (d >= 0) & (d < window)}

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw)

    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            # a backend that refuses the call says why in a warning
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                call()
                torch.cuda.synchronize()
                return time_ms(call), backend.name
        except RuntimeError:
            continue
    raise AssertionError("no SDPA backend takes the call")


def local_attention_times(card: str) -> dict:
    """K6 in bfloat16 at head dim 256 (``ATTN_SHAPES_256``): the kernel,
    its plain version and SDPA by ``time_ms``, beside the bound (the
    visible pairs' operations at 989 TFLOP/s, or the bytes)."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ref import mha_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    out = {}
    for what, ((B, Hq, Hkv, S, D), window) in ATTN_SHAPES_256.items():
        q, k, v = (torch.randn(B, h, S, D, generator=gen,
                               device=dev).bfloat16()
                   for h in (Hq, Hkv, Hkv))
        nbytes, ops = attn_work(B, Hq, Hkv, S, S, D, 2, window=window)
        b_ms, b_by = bound(nbytes, ops, BF16_TC_OPS_PER_S)
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, window=window))
        plain = time_ms(lambda: mha_ref(q, k, v, window=window), iters=10)
        lib, backend = sdpa_ms(q, k, v, window)
        out[what] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "library_ms": lib, "backend": backend}
        log(f"time flash_attention bfloat16 {what} {(B, Hq, Hkv, S, D)} "
            f"window {window}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {nbytes} bytes, {ops} ops), plain {plain:.4f} ms, "
            f"SDPA {lib:.4f} ms ({backend}) ({card})")
        del q, k, v
    torch.cuda.empty_cache()
    return out


def serving_attention_parity() -> float:
    """K6 at the prefill shapes of phase 3g's and 3h's archs
    (``ATTN_SHAPES_3G``: MHA 20/20, GQA 32/2, llava's 2560 positions, head
    dim 64 without a mask over 4096 frames and from 512 queries to 4096
    keys, arctic-480b's GQA 56/8) against
    ``mha_ref`` on the same inputs, float32 and bfloat16, within
    ``LM_KERNEL_TOL``; in bfloat16 the kernel with its mask flipped
    (causal where the shape has none, none where it is causal) must fall
    outside the limit.  Returns the largest float32 difference."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ref import mha_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    worst = 0.0
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        lim = LM_KERNEL_TOL["flash_attention"][dname]
        for what, ((B, Hq, Hkv, Sq, Skv, D), causal) in \
                ATTN_SHAPES_3G.items():
            q = torch.randn(B, Hq, Sq, D, generator=gen, device=dev).to(dt)
            k, v = (torch.randn(B, Hkv, Skv, D, generator=gen,
                                device=dev).to(dt) for _ in range(2))
            want = mha_ref(q, k, v, causal=causal)
            shape = (B, Hq, Hkv, Sq, Skv, D)
            e = max_err(flash_attention_cuda(q, k, v, causal=causal), want,
                        lim[0], f"flash_attention {dname} {what} {shape} "
                                f"{'causal' if causal else 'no mask'}",
                        rtol=lim[1])
            if dname == "float32":
                worst = max(worst, e)
            else:
                err, bad = outside(flash_attention_cuda(
                    q, k, v, causal=not causal), want, *lim)
                log(f"flash_attention {dname} {what} wrong variant (the "
                    f"mask flipped): max_abs_err={err:.3e}, {bad} values "
                    f"outside the limit")
                if not bad:
                    raise AssertionError(f"flash_attention {what}: the limit "
                                         f"does not see a flipped mask")
            del q, k, v, want
    torch.cuda.empty_cache()
    return worst


def serving_attention_times(card: str) -> dict:
    """K6 in bfloat16 at ``ATTN_SHAPES_3G``: the kernel, its plain
    version and SDPA (``enable_gqa``; the first backend that takes the
    call) by ``time_ms``, beside the bound (the visible pairs' operations
    at 989 TFLOP/s, or the bytes)."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ref import mha_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    out = {}
    for what, ((B, Hq, Hkv, Sq, Skv, D), causal) in ATTN_SHAPES_3G.items():
        q = torch.randn(B, Hq, Sq, D, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, Hkv, Skv, D, generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        nbytes, ops = attn_work(B, Hq, Hkv, Sq, Skv, D, 2, causal=causal)
        b_ms, b_by = bound(nbytes, ops, BF16_TC_OPS_PER_S)
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal))
        plain = time_ms(lambda: mha_ref(q, k, v, causal=causal), iters=10)
        lib, backend = sdpa_ms(q, k, v, None, causal=causal)
        out[what] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "library_ms": lib, "backend": backend}
        log(f"time flash_attention bfloat16 {what} "
            f"{(B, Hq, Hkv, Sq, Skv, D)} {'causal' if causal else 'no mask'}"
            f": kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes} "
            f"bytes, {ops} ops), plain {plain:.4f} ms, SDPA {lib:.4f} ms "
            f"({backend}) ({card})")
        del q, k, v
    torch.cuda.empty_cache()
    return out


def frontend_inputs(cfg, rows: int, rng) -> dict:
    """A request's frames (``ENC_LEN_SERVE`` of them, encoder-decoder) or
    patch embeddings (``frontend_tokens``, VLM) from ``rng``, on the card
    in float32, as ``launch/serve.py``'s ``serve_legacy`` makes them."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import ENC_LEN_SERVE

    if cfg.is_encdec:
        key, n = "frames", ENC_LEN_SERVE
    else:
        key, n = "patches", cfg.frontend_tokens
    x = rng.standard_normal((rows, n, cfg.frontend_dim)).astype(np.float32)
    return {key: torch.from_numpy(x).to("cuda")}


def serve_frontend(arch: str, card: str, zero_counts, read_counts) -> dict:
    """Serve ``arch`` (seamless-m4t-medium or llava-next-mistral-7b) at
    its published config through the uniform loop (``legacy_generate``,
    where ``launch/serve.py`` sends these archs): ``FRONTEND_ROWS`` rows
    of ``FRONTEND_PROMPT`` tokens with their frames or patches, ``LM_GEN``
    new tokens each, prefilled in one call.  Checked: K6 once per
    attention layer (the encoder's, the decoder's self- and
    cross-attention) over the rows, the kernel
    route's prefill logits against the plain route's (the encoder run
    causal, or llava without its causal mask, outside the limit) and the
    decode check (``frontend_decode_check``).  Measured: prefill ms a row
    (seamless: the encoder's alone too), decode ms a step, tokens/s."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import legacy_generate
    from repro_torch.models import attention as model_attention
    from repro_torch.models.lm import encode, init_lm, prefill

    dev = torch.device("cuda")
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log(f"{arch}: {cfg.n_layers} decoder layers, {cfg.enc_layers} encoder "
        f"layers, d_model {cfg.d_model}, head dim {cfg.head_dim}, "
        f"{sum(p.numel() for p in params.parameters())} parameters in "
        f"{cfg.param_dtype} made on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (FRONTEND_ROWS, FRONTEND_PROMPT)).astype(
            np.int32)).to(dev)
    fr = frontend_inputs(cfg, FRONTEND_ROWS, rng)
    front = 0 if cfg.is_encdec else cfg.frontend_tokens
    max_seq = FRONTEND_PROMPT + LM_GEN + front

    # the main path: the uniform loop, one prefill over the rows (K6 once
    # at every attention layer, over the whole batch), the decode steps
    # over the whole batch
    legacy_generate(cfg, params, tokens[:1], 2, max_seq,
                    **{k: v[:1] for k, v in fr.items()})   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    gen, t_pre, t_dec = legacy_generate(cfg, params, tokens, LM_GEN,
                                        max_seq, **fr)
    counts = read_counts()
    per_row = cfg.n_layers * (2 if cfg.is_encdec else 1) + cfg.enc_layers
    expect = {"flash_attention": per_row, "ssd_intra_chunk": 0}
    if gen.shape != (FRONTEND_ROWS, LM_GEN) or not (
            (gen >= 0) & (gen < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: generated {gen.shape} tokens, or "
                             f"some outside the vocabulary")
    step_ms = t_dec / (LM_GEN - 1) * 1e3
    tok_s = FRONTEND_ROWS * LM_GEN / (t_pre + t_dec)
    log(f"main path {arch}: {FRONTEND_ROWS} rows of {FRONTEND_PROMPT} "
        f"tokens{f' + {front} patch positions' if front else ''}"
        f"{' with 4096 frames each' if cfg.is_encdec else ''}, {LM_GEN} new "
        f"each: prefill {t_pre * 1e3:.1f} ms ({t_pre * 1e3 / FRONTEND_ROWS:.1f}"
        f" a row), decode {step_ms:.3f} ms per step ({FRONTEND_ROWS} rows), "
        f"{tok_s:.1f} tokens/s end to end, "
        f"{FRONTEND_ROWS * (LM_GEN - 1) / t_dec:.1f} decoding; K6 "
        f"{counts['flash_attention']} launches (one per attention layer, "
        f"over the {FRONTEND_ROWS} rows); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card})")

    # prefill ms of one row, and the encoder's alone, synchronised
    row = {"tokens": tokens[:1], **{k: v[:1] for k, v in fr.items()}}

    def wall_ms(fn, n=3):
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        return statistics.median(walls)

    prefill_ms = wall_ms(lambda: prefill(params, row, cfg, max_seq=max_seq))
    encoder_ms = (wall_ms(lambda: encode(params, row["frames"], cfg))
                  if cfg.is_encdec else None)
    log(f"{arch} prefill of one row: {prefill_ms:.3f} ms (median of 3)"
        f"{f', the encoder alone {encoder_ms:.3f} ms' if encoder_ms else ''}"
        f" ({card})")

    # the kernel route's last-position logits against the plain route's
    def logits(use_kernel=True):
        return prefill(params, row, cfg, max_seq=max_seq,
                       use_kernel=use_kernel)[0].float()

    got, want = logits(), logits(use_kernel=False)
    if tuple(got.shape) != (1, cfg.padded_vocab()) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{arch}: prefill logits of shape "
                             f"{tuple(got.shape)}, or not finite")
    err = float((got - want).abs().max())
    log(f"{arch} prefill logits, kernel route vs plain route: max "
        f"|difference| {err:.4e} (limit {LOGIT_TOL[arch]:g}, plain logits "
        f"max |x| {float(want.abs().max()):.3f}); argmax equal: "
        f"{int(got.argmax()) == int(want.argmax())}")
    if not err <= LOGIT_TOL[arch]:
        raise AssertionError(f"{arch}: prefill logits outside the limit")
    real = model_attention.flash_attention_fn
    if cfg.is_encdec:
        # every self-attention causal: the decoder's is already, so the
        # encoder's changes; the cross-attention (512 queries, 4096 keys)
        # is left as it is
        what = "the encoder run causal"
        model_attention.flash_attention_fn = lambda q, k, v, **kw: real(
            q, k, v, **{**kw, "causal": kw["causal"]
                        or q.shape[1] == k.shape[1]})
    else:
        what = "attention without its causal mask"
        model_attention.flash_attention_fn = lambda *a, **kw: real(
            *a, **{**kw, "causal": False})
    try:
        wrong = logits()
    finally:
        model_attention.flash_attention_fn = real
    werr = float((wrong - want).abs().max())
    log(f"{arch} wrong variant ({what}): max |difference| {werr:.4e} "
        f"against the plain route (limit {LOGIT_TOL[arch]:g})")
    if not werr > LOGIT_TOL[arch]:
        raise AssertionError(f"{arch}: the logits limit does not see {what}")
    decode = frontend_decode_check(arch, card, cfg, params)
    return {"counts": counts, "expect": expect, "prefill_ms": prefill_ms,
            "row_prefill_ms": t_pre * 1e3 / FRONTEND_ROWS,
            "encoder_ms": encoder_ms, "step_ms": step_ms, "tok_s": tok_s,
            "decode_tok_s": FRONTEND_ROWS * (LM_GEN - 1) / t_dec,
            "logit_err": err, "wrong_err": werr, "decode": decode}


def frontend_decode_check(arch: str, card: str, cfg, params) -> dict:
    """Decode against one prefill: ``FRONTEND_PROMPT`` tokens prefilled
    with a row's frames or patches, ``FRONTEND_DECODE`` more
    teacher-forced through the uniform loop's decode step (seamless: its
    ``ENC_LEN_SERVE`` cross slots read); the last step's logits within
    ``FRONTEND_DECODE_TOL`` of the last-position logits of one prefill
    over all the tokens with the same frames or patches.  The wrong
    variants must fall outside: seamless's cross caches with their values
    zeroed (and, printed, built from other frames); llava's decode
    positions without the 2048 patch positions."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import kvcache as kvc
    from repro_torch.models.lm import prefill

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    n = FRONTEND_PROMPT + FRONTEND_DECODE
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)).astype(
        np.int32)).to(dev)
    fr = frontend_inputs(cfg, 1, rng)
    front = 0 if cfg.is_encdec else cfg.frontend_tokens
    step = make_decode_step(cfg)

    def map_cross(caches, fn):
        return {**caches, "groups": [
            {key: {**e, "cross": fn(e["cross"])} for key, e in g.items()}
            for g in caches["groups"]],
            "tail": [{**e, "cross": fn(e["cross"])}
                     for e in caches["tail"]]}

    def zero_values(store):
        k, v = kvc.kv_read(store, cfg.head_dim, cfg.kv_layout, cfg.kv_order)
        return kvc.kv_write_prefill(store, k, torch.zeros_like(v),
                                    cfg.kv_layout, cfg.kv_order)

    def decoded(alter=None):
        _, caches = prefill(params, {"tokens": toks[:, :FRONTEND_PROMPT],
                                     **fr}, cfg, max_seq=n + front)
        if alter is not None:
            caches = alter(caches)
        for t in range(FRONTEND_PROMPT, n):
            logits, caches = step(params, caches, toks[:, t])
        return logits.float()

    want = prefill(params, {"tokens": toks, **fr}, cfg,
                   max_seq=n + front)[0].float()
    got = decoded()
    err = float((got - want).abs().max())
    if cfg.is_encdec:
        variants = {"the cross caches' values zeroed": (
            lambda c: map_cross(c, zero_values), True)}
        other = frontend_inputs(cfg, 1, np.random.default_rng(3))
        other_cross = prefill(params, {"tokens": toks[:, :FRONTEND_PROMPT],
                                       **other}, cfg, max_seq=n)[1]
        crosses = iter([e["cross"] for g in other_cross["groups"]
                        for e in g.values()]
                       + [e["cross"] for e in other_cross["tail"]])
        variants["the cross caches built from other frames"] = (
            lambda c: map_cross(c, lambda _: next(crosses)), False)
    else:
        variants = {"decode positions without the patch positions": (
            lambda c: {**c, "pos": c["pos"] - front}, True)}
    wrong = {}
    for what, (alter, gated) in variants.items():
        wrong[what] = float((decoded(alter) - want).abs().max())
        log(f"{arch} decode check wrong variant ({what}): max |difference| "
            f"{wrong[what]:.4e} (limit {FRONTEND_DECODE_TOL[arch]:g}"
            f"{'' if gated else '; printed, not gated'})")
        if gated and not wrong[what] > FRONTEND_DECODE_TOL[arch]:
            raise AssertionError(f"{arch}: the decode check's limit does not "
                                 f"see {what}")
    log(f"{arch} decode check ({FRONTEND_PROMPT} tokens prefilled, "
        f"{FRONTEND_DECODE} decoded): last logits against one prefill of "
        f"{n} tokens max |difference| {err:.4e} (limit "
        f"{FRONTEND_DECODE_TOL[arch]:g}, max |x| "
        f"{float(want.abs().max()):.3f}); argmax equal: "
        f"{int(got.argmax()) == int(want.argmax())} ({card})")
    if not (torch.isfinite(got).all() and err <= FRONTEND_DECODE_TOL[arch]):
        raise AssertionError(f"{arch}: the decode check is outside its "
                             f"limit")
    return {"err": err, "wrong": wrong}


def captured_prefills():
    """``Batcher`` with each prompt length's prefill captured once, at the
    executor's defaults, where the batcher runs its prefills eagerly: the
    alternative the serving phase measures against them."""
    from repro_torch.core.executor import Executor
    from repro_torch.launch.steps import make_prefill_graph
    from repro_torch.runtime.batcher import Batcher

    class CapturedPrefills(Batcher):
        def _prefill_for(self, prompt_len: int):
            if prompt_len not in self._prefill:
                pg = make_prefill_graph(self.cfg, self.params,
                                        prompt_len=prompt_len,
                                        max_seq=self.max_seq)
                self._prefill[prompt_len] = (pg, Executor(pg.graph,
                                                          self.device))
            return self._prefill[prompt_len]

    return CapturedPrefills


def served(batcher, reqs, zero_counts) -> tuple:
    """Drain ``batcher`` (its requests ``reqs`` submitted), timed on the
    host clock between two synchronisations; the launch counts are set
    to 0 just before.  Returns the tokens, the seconds and the decode ms
    per step (the median gap between the batcher's harvests)."""
    import torch

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(len(r.generated) != r.max_new_tokens or r.status != "done"
           for r in reqs):
        raise AssertionError("the batcher did not serve every request in "
                             "full")
    harvests = sorted({t for r in reqs for t in r.token_times[1:]})
    step_ms = statistics.median(
        (b - a) * 1e3 for a, b in zip(harvests, harvests[1:]))
    return sum(len(r.generated) for r in reqs), wall, step_ms


def interleaved(arch: str, card: str, one, two, prompts, reqs) -> dict:
    """Two live batchers of one decode signature (``one`` and ``two``,
    drained) given the first ``LM_SLOTS`` prompts each, stepped in turn
    for ``LM_INTERLEAVE_STEPS`` pairs, then ``one`` alone as long: ms a
    step both ways, and the bytes moved out onto copies a step.  Both
    must then finish with the streams of ``reqs``."""
    import torch

    ex = one.executor
    mine = [one.submit(p, max_new_tokens=LM_GEN)
            for p in prompts[:LM_SLOTS]]
    theirs = [two.submit(p, max_new_tokens=LM_GEN)
              for p in prompts[:LM_SLOTS]]
    one.step()
    two.step()                      # both admitted
    torch.cuda.synchronize()
    moved = ex.cache_stats()["moved_out_bytes"]
    t0 = time.perf_counter()
    for _ in range(LM_INTERLEAVE_STEPS):
        one.step()
        two.step()
    torch.cuda.synchronize()
    turn_ms = (time.perf_counter() - t0) * 1e3 / (2 * LM_INTERLEAVE_STEPS)
    per_step = (ex.cache_stats()["moved_out_bytes"] - moved) \
        / (2 * LM_INTERLEAVE_STEPS)
    one.step()                      # takes its state back: one more move
    torch.cuda.synchronize()
    moved = ex.cache_stats()["moved_out_bytes"]
    t0 = time.perf_counter()
    for _ in range(LM_INTERLEAVE_STEPS):
        one.step()
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t0) * 1e3 / LM_INTERLEAVE_STEPS
    alone_moved = ex.cache_stats()["moved_out_bytes"] - moved
    one.run()
    two.run()
    if [r.generated for r in mine] != [r.generated for r in reqs[:LM_SLOTS]] \
            or [r.generated for r in theirs] != \
            [r.generated for r in reqs[:LM_SLOTS]] or alone_moved:
        raise AssertionError(f"interleaved {arch}: the two batchers' "
                             f"streams differ from the first run's, or a "
                             f"step alone moved {alone_moved} bytes")
    state_bytes = sum(v.numel() * v.element_size()
                      for v in one.state.values())
    log(f"interleaved {arch}: two batchers of one signature stepped in "
        f"turn, {LM_INTERLEAVE_STEPS} pairs: {turn_ms:.3f} ms a step, "
        f"{per_step:.0f} bytes moved out a step (the decode state holds "
        f"{state_bytes}); one alone {alone_ms:.3f} ms a step, 0 bytes "
        f"moved; streams equal the first run's ({card})")
    return {"turn_ms": turn_ms, "alone_ms": alone_ms,
            "moved_per_step": per_step, "state_bytes": state_bytes}


def bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (NaNs included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                       b.reshape(-1).contiguous().view(torch.uint8))


def check_bits(what: str, got: dict, want: dict) -> None:
    """Every field of ``got`` equal to ``want``'s bit for bit, or raise."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys {sorted(got)} against "
                             f"{sorted(want)}")
    bad = [k for k in want if not bits_equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"{what}: {bad} differ from regions=False")


class Stamped:
    """A loop predicate that stamps the host clock at each check."""

    def __init__(self, pred):
        self.pred = pred
        self.stamps: list[float] = []

    def __call__(self, state) -> bool:
        go = self.pred(state)
        self.stamps.append(time.perf_counter())
        return go


# the kernels of a main-path graph's step (the eikonal solve's:
# iteration), by wrapper; the profiler's names of each, and the pieces of
# its mangled names in a captured graph's kernel nodes (the max/min's
# read, span or row by row; its one-block fold is not counted)
REGION_KERNELS = {"saxpy_probe": {"saxpy": 2},
                  "particle_step": {"saxpy_record": 1, "particle_update": 2,
                                    "nan_ignoring_extremum": 1},
                  "flux": {"flux_difference": 1},
                  "eikonal_solve": {"eikonal_fim": 1,
                                    "nan_ignoring_extremum": 1}}
KERNEL_SYMBOLS = {"saxpy": ("::saxpy_kernel<", ("12saxpy_kernelI",)),
                  "saxpy_record": ("::saxpy_record_kernel<",
                                   ("19saxpy_record_kernelI",)),
                  "particle_update": ("::particle_kernel<",
                                      ("15particle_kernelI",)),
                  "flux_difference": ("::flux_kernel<",
                                      ("11flux_kernelI",)),
                  "eikonal_fim": ("::fim_kernel<", ("10fim_kernelI",)),
                  "flash_attention": ("::attn_", ("15attn_f32_kernelI",
                                                  "17attn_wgmma_kernelI")),
                  "ssd_intra_chunk": ("::ssd_", ("16ssd_chunk_kernelI",
                                                 "16ssd_wgmma_kernelI")),
                  "nan_ignoring_extremum": (
                      ("::extremum_span_kernel<", "::extremum_rows_kernel<"),
                      ("20extremum_span_kernelI", "20extremum_rows_kernelI"))}
GRAPH_DUMPS = os.path.join("build", "graph-dumps")
# a memcpy node of CUDA's DOT print (cudaGraphDebugDotFlagsVerbose), with
# its extent in bytes, and the mangled name of PyTorch's copy kernel (a
# copy between strided tensors, which is a kernel node, not a memcpy)
MEMCPY_NODE = re.compile(r"MEMCPY.*?\{Width \| (\d+)\} \| \{Height \| "
                         r"(\d+)\} \| \{Depth \| (\d+)\}", re.S)
COPY_KERNEL_SYMBOL = "direct_copy_kernel_cuda"


def forced_copies(name: str) -> list:
    """The memcpy nodes a main-path graph's capture holds once its kernels
    write their static buffers in place (``out=``), as ``(why, bytes)``:
    what aliasing and the halo fill force.  The saxpy probe, the particle
    step and the flux step hold none (the flux step's padded state is
    nine strided SoA placements and its fills, copy kernels).  An eikonal
    iteration holds the body's own ``phi_prev <- phi`` (phi's buffer is
    K5's output, so phi_prev takes a copy of it), the padded phi's
    contiguous pieces: each row halo made from its edge row and placed,
    each corner made from its row's end and placed (the column halos and
    the interior are strided: copy kernels).  The NaN-ignoring max reads
    ``change`` where it lies (``csrc/reduce.cu``): it copies nothing."""
    if name != "eikonal_solve":
        return []
    row, cell, grid = 4 * EIK_N, 4, 4 * EIK_N * EIK_N
    return ([("phi_prev <- phi, the body's own copy", grid)]
            + [("padded phi: a row halo filled from its edge row", row)] * 2
            + [("padded phi: a corner filled from its row's end", cell)] * 4
            + [("padded phi: a row halo placed", row)] * 2
            + [("padded phi: a corner placed", cell)] * 4)


def forced_summary(name: str) -> str:
    """The forced copies of a graph, counted by reason."""
    seen: dict = {}
    for why, nbytes in forced_copies(name):
        seen.setdefault(f"{why} ({nbytes} B)", 0)
        seen[f"{why} ({nbytes} B)"] += 1
    return "; ".join(f"{n} x {w}" for w, n in seen.items()) or "none"


def span_bytes(view) -> int:
    """Bytes from a view's first element to one past its last."""
    last = sum((n - 1) * s for n, s in zip(view.shape, view.stride()))
    return (last + 1) * view.element_size()


def extremum_parity(views: dict) -> float:
    """The NaN-ignoring max and min kernel against the torch route
    (``kernels/reduce/ref.py``) at the main path's views (``views``: name
    -> a 2-d float32 view on the card, filled here in place), each filled
    four ways in turn: drawn N(0, 1); NaN planted at its first and last
    element and at 1 % of the others; +inf and -inf planted beside the
    NaN; all NaN.  The max goes into a 0-d ``out``, as in the executor's
    pieces.  Limit 0: equal, NaN to NaN.  Returns the largest difference
    (0.0)."""
    import torch

    from repro_torch.kernels.reduce.kernel import nan_ignoring_extremum_cuda
    from repro_torch.kernels.reduce.ref import nan_ignoring_extremum_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    nan, inf = float("nan"), float("inf")
    for what, view in views.items():
        rows, cols = view.shape
        k = max(1, view.numel() // 100)
        at = (torch.randint(rows, (k,), generator=gen, device=view.device),
              torch.randint(cols, (k,), generator=gen, device=view.device))
        out = torch.empty((), device=view.device)

        def check(pattern):
            got = {}
            for largest in (True, False):
                m = got["max" if largest else "min"] = \
                    nan_ignoring_extremum_cuda(view, largest=largest,
                                               out=out if largest else None)
                want = nan_ignoring_extremum_ref(view, largest=largest)
                if largest and m is not out:
                    raise AssertionError(f"nan_ignoring_extremum {what}: "
                                         f"the max did not land in out")
                if not (torch.equal(m, want)
                        or bool(m.isnan() & want.isnan())):
                    raise AssertionError(
                        f"nan_ignoring_extremum {what} ({pattern}) "
                        f"{'max' if largest else 'min'}: {float(m)}, the "
                        f"torch route {float(want)}")
            log(f"nan_ignoring_extremum {what} {tuple(view.shape)} strides "
                f"{view.stride()} offset {view.storage_offset()} "
                f"({pattern}): max {float(got['max'])}, min "
                f"{float(got['min'])}, the torch route's")

        view.normal_(generator=gen)
        check("drawn N(0, 1)")
        view[0, 0] = nan
        view[-1, -1] = nan
        view[at] = nan
        check("NaN at both ends and at 1 % of the elements")
        view[rows // 3, cols // 2] = inf
        view[2 * rows // 3, cols - 1] = -inf
        check("+inf and -inf beside the NaN")
        view.fill_(nan)
        check("all NaN")
    return 0.0


def check_memcpys(what: str, got: list, want: list) -> None:
    """The graphs' memcpy nodes are the forced copies, byte for byte."""
    if sorted(got) != sorted(b for _, b in want):
        raise AssertionError(
            f"{what}: memcpy nodes of {sorted(got)} bytes, the copies that "
            f"aliasing and the halo fill force are "
            f"{sorted(b for _, b in want)} ({[w for w, _ in want]})")


def check_counts(what: str, counts: dict, want: dict) -> None:
    """Every count equal to ``want``'s (0 where it has none)."""
    bad = {k: n for k, n in counts.items() if n != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: {bad}, expected {want}")


def traced_counts(by_kernel: dict) -> dict:
    """Launches of each kernel of ``KERNEL_SYMBOLS`` in a profiler trace."""
    names = {k: (sym,) if isinstance(sym, str) else sym
             for k, (sym, _) in KERNEL_SYMBOLS.items()}
    return {k: sum(n for name, (_, n) in by_kernel.items()
                   if any(sym in name for sym in syms))
            for k, syms in names.items()}


class GraphNodes:
    """While active, every ``torch.cuda.CUDAGraph`` is made in debug mode
    and kept until :meth:`read`, which counts the kernel nodes of each
    kernel of ``KERNEL_SYMBOLS`` in the graphs made since the last read
    (from CUDA's DOT print of each graph) and lets them go.  A replay
    runs every node of its graph, so these are the launches of a
    replay."""

    def __init__(self):
        import torch

        self.real = torch.cuda.CUDAGraph
        made = self.made = []

        class DebugGraph(self.real):
            def __init__(self, keep_graph: bool = False):
                # keep the cudaGraph_t for debug_dump (torch 2.11 drops
                # it at capture_end otherwise, debug mode or not); the
                # first replay instantiates it
                super().__init__(True)
                self.enable_debug_mode()
                made.append(self)

        self.debug = DebugGraph

    def __enter__(self):
        import torch

        torch.cuda.CUDAGraph = self.debug
        os.makedirs(GRAPH_DUMPS, exist_ok=True)
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.CUDAGraph = self.real
        self.made.clear()

    def read(self) -> tuple[int, dict]:
        """``(graphs, kernel nodes by kernel)``; the memcpy nodes (bytes
        each) and the copy-kernel nodes of the same graphs are left in
        ``memcpys`` and ``copy_kernels``."""
        counts = {k: 0 for k in KERNEL_SYMBOLS}
        self.memcpys, self.copy_kernels = [], 0
        n = len(self.made)
        for i, graph in enumerate(self.made):
            path = os.path.join(GRAPH_DUMPS, f"graph{i}.dot")
            graph.debug_dump(path)
            with open(path) as f:
                text = f.read()
            for k, (_, syms) in KERNEL_SYMBOLS.items():
                counts[k] += sum(text.count(sym) for sym in syms)
            self.memcpys += [int(w) * int(h) * int(d)
                             for w, h, d in MEMCPY_NODE.findall(text)]
            self.copy_kernels += text.count(COPY_KERNEL_SYMBOL)
            os.remove(path)
        self.made.clear()
        return n, counts


def out_checks(card: str, eik_mid, mask) -> None:
    """K1-K5 writing ``out=`` at the main path's shapes, float32 and
    bfloat16, every layout each takes: ``out`` apart from the inputs, and
    for K1-K3 ``out`` the updated input itself (their CUDA pointers carry
    no ``__restrict__``), each bit for bit the fresh-output call.  These
    launches compare kernels and join no count."""
    import torch

    from repro_torch import workloads
    from repro_torch.core import Boundary, Layout, RecordArray, \
        pad_boundary_only
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.kernel import (saxpy_cuda,
                                                  saxpy_record_cuda)
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC
    from repro_torch.kernels.stencil.kernel import flux_difference_cuda
    from repro_torch.kernels.stencil.ops import flux_difference
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    checked = []

    def same(what, got, want):
        if not bits_equal(got, want):
            raise AssertionError(f"out= {what}: differs from the "
                                 f"fresh-output call")
        checked.append(what)

    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x = torch.randn(SAXPY_N, generator=gen, device=dev).to(dt)
        y = torch.randn(SAXPY_N, generator=gen, device=dev).to(dt)
        for bc in (True, False):
            want = saxpy_cuda(SAXPY_A, x, y, bounds_check=bc)
            apart = torch.empty_like(y)
            saxpy_cuda(SAXPY_A, x, y, bounds_check=bc, out=apart)
            same(f"K1 {dname} bc={bc} apart", apart, want)
            inplace = y.clone()
            saxpy_cuda(SAXPY_A, x, inplace, bounds_check=bc, out=inplace)
            same(f"K1 {dname} bc={bc} in place", inplace, want)
        del x, y, want, apart, inplace
        for lay in Layout:
            for k, fn, spec, c in (
                    ("K2", saxpy_record_cuda, SAXPY_SPEC, 2),
                    ("K3", particle_update_cuda, PARTICLE_SPEC, 6)):
                rec = RecordArray(torch.randn(c, PARTICLE_N, generator=gen,
                                              device=dev).to(dt), spec,
                                  Layout.SOA).with_layout(lay)
                want = fn(rec, workloads.DT).data
                apart = RecordArray(torch.empty_like(rec.data), spec, lay)
                fn(rec, workloads.DT, out=apart)
                same(f"{k} {dname} {lay.name} apart", apart.data, want)
                fn(rec, workloads.DT, out=rec)
                same(f"{k} {dname} {lay.name} in place", rec.data, want)
                del rec, want, apart
        u = shock_bubble_init(FLUX_N, FLUX_N, device=dev).to(dt)
        for ax in (1, 2):
            u = pad_boundary_only(u, axis=ax, width=1,
                                  boundary=Boundary.TRANSMISSIVE)
        for lay in Layout:   # AoSoA through the ops wrapper's relayout
            rec = RecordArray(u, EULER_SPEC, Layout.SOA).with_layout(lay)
            if lay is Layout.AOSOA:
                want = flux_difference(rec, *FLUX_PARITY_LAM).data
                apart = RecordArray(torch.empty_like(want), EULER_SPEC, lay)
                flux_difference(rec, *FLUX_PARITY_LAM, out=apart)
            else:
                want = flux_difference_cuda(rec, *FLUX_PARITY_LAM).data
                apart = RecordArray(torch.empty_like(want), EULER_SPEC, lay)
                flux_difference_cuda(rec, *FLUX_PARITY_LAM, out=apart)
            same(f"K4 {dname} {lay.name} apart", apart.data, want)
            del rec, want, apart
        del u
        phi = eik_mid.to(dt)
        want = eikonal_fim_cuda(phi, mask, 1 / EIK_N, inner=EIK_INNER,
                                block=EIK_BLOCK)
        apart = torch.empty_like(want)
        eikonal_fim_cuda(phi, mask, 1 / EIK_N, inner=EIK_INNER,
                         block=EIK_BLOCK, out=apart)
        same(f"K5 {dname} apart", apart, want)
        del phi, want, apart
        torch.cuda.empty_cache()
    log(f"out= on the card: {len(checked)} calls bit for bit the "
        f"fresh-output ones (K1 BC/NBC, K2 and K3 every layout, apart and "
        f"in place; K4 AoS/SoA/AoSoA and K5 apart; float32 and bfloat16 "
        f"at the main path's shapes) ({card})")


def regions_graph(name: str, seed: int):
    """``(graph, init overrides, steps, converging)`` of one main-path graph
    at its chip size, the inputs from ``default_rng(seed)`` (seed 0: the
    main path's own inputs)."""
    import numpy as np
    import torch

    from repro_torch import workloads
    from repro_torch.core import Layout, RecordArray
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC
    from repro_torch.physics.euler import shock_bubble_init

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    if name == "saxpy_probe":
        g, _ = workloads.build_saxpy_graph(SAXPY_N, SAXPY_A)
        return g, {"x": rng.standard_normal(SAXPY_N, dtype=np.float32)}, \
            SAXPY_STEPS, None
    if name == "particle_step":
        g, _, _ = workloads.build_particle_graph(PARTICLE_N)
        f = workloads.particle_fields(PARTICLE_N, seed)
        specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
                 "electrons": (PARTICLE_SPEC, Layout.AOSOA),
                 "field": (SAXPY_SPEC, Layout.SOA)}
        return g, {k: RecordArray.from_fields(
            spec, {fn: torch.from_numpy(v).to(dev) for fn, v in
                   f[k].items()}, lay)
            for k, (spec, lay) in specs.items()}, PARTICLE_STEPS, None
    if name == "flux":
        g, _ = workloads.build_flux_graph(FLUX_N, FLUX_N, lam_x=FLUX_LAM,
                                          lam_y=FLUX_LAM)
        u = shock_bubble_init(FLUX_N, FLUX_N, device=dev)
        if seed:   # every cell scaled by 1 +- 1 %: still a valid state
            u = u * torch.from_numpy(rng.uniform(
                0.99, 1.01, tuple(u.shape)).astype(np.float32)).to(dev)
        return g, {"u": u}, FLUX_STEPS, None
    g, _, converging = workloads.build_eikonal_graph(
        EIK_N, inner=EIK_INNER, block=EIK_BLOCK, max_iters=4 * EIK_N)
    inp = workloads.eikonal_inputs(EIK_N)
    if seed:
        inp["phi"] = np.where(inp["mask"], 0.0, 1e3 * rng.uniform(
            0.5, 1.0, inp["phi"].shape)).astype(np.float32)
    return g, inp, None, converging


def regions_phase(card: str, zero_counts, counts_now) -> dict:
    """Region compile on the card: each main-path graph with
    ``regions=False`` and with ``regions=True`` under ``donate=False`` and
    ``donate=True``, from the same inputs; the final states equal bit for
    bit, zero captures in steady state and for a second executor, a state
    from another seed after capture equal to the eager run on it, the
    wrappers called twice a step by the build and never by a replay, the
    graph's kernels as kernel nodes of the captured graphs, and the times
    both ways.  Returns the numbers by graph and mode."""
    import torch

    from repro_torch.core import (Executor, clear_executable_cache,
                                  executable_cache_stats)

    clear_executable_cache()
    out = {}
    for name in ("saxpy_probe", "particle_step", "flux", "eikonal_solve"):
        g, inp0, steps, converging = regions_graph(name, 0)
        _, inp1, _, _ = regions_graph(name, 1)
        if converging is not None:
            # an object, not a closure: the plan signature keys a closure's
            # values (the stamps would make every executor's plan new) and
            # an object by its identity
            stamped = Stamped(converging)
            stamps = stamped.stamps
            g.levels[0][0].subgraph.conditional(stamped)

        def drive(ex, inp):
            """The graph's whole run: ``steps`` steps one call each, or one
            solve; returns the state and the median ms per step (per
            iteration of the solve, from the predicate's stamps)."""
            state = ex.init_state(**inp)
            if converging is None:
                return run_steps(ex, state, steps)
            stamps.clear()
            torch.cuda.synchronize()
            state = ex(state)
            torch.cuda.synchronize()
            return state, statistics.median(
                (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))

        def whole(ex, inp):
            """One ``run(state, steps)`` (one call of the solve): wall ms
            per step or per iteration, the copies in and out included."""
            state = ex.init_state(**inp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = ex.run(state, steps or 1)
            torch.cuda.synchronize()
            n = steps or converging.iterations
            return state, (time.perf_counter() - t0) * 1e3 / n

        def busy(ex, inp):
            """Device ms of one step (of the whole solve) under the
            profiler, after two warm-up steps (the trace can lose a short
            step's first launches), and the trace's launches of the
            graph's kernels against those the step makes."""
            state = ex.init_state(**inp)
            if converging is None:
                state = ex.run(state, 1)
            by_kernel = device_time_by_kernel(
                lambda: ex.run(state, 1),
                warmup=0 if converging else 2)
            n = converging.iterations if converging else 1
            seen = traced_counts(by_kernel)
            held = (f"its trace holds {sum(seen.values())} of the "
                    f"{n * sum(per_step.values())} launches of "
                    f"{'/'.join(per_step)}")
            return (sum(us for us, _ in by_kernel.values()) / 1e3,
                    by_kernel, held)

        def top(by_kernel):
            for kname, (us, count) in sorted(
                    by_kernel.items(), key=lambda kv: -kv[1][0])[:6]:
                log(f"  {us / 1e3:.4f} ms, {count} launches: {kname[:90]}")

        per_step = REGION_KERNELS[name]
        eager = Executor(g, regions=False)
        want0, eager_ms = drive(eager, inp0)
        iters0 = converging.iterations if converging else steps
        want1, _ = drive(eager, inp1)
        iters1 = converging.iterations if converging else steps
        _, eager_whole = whole(eager, inp0)
        eager_busy, by_kernel, held = busy(eager, inp0)
        log(f"regions {name} eager: device busy {eager_busy:.4f} ms; "
            f"{held} ({card})")
        top(by_kernel)
        row = {"eager_ms": eager_ms, "eager_whole_ms": eager_whole,
               "eager_busy_ms": eager_busy, "iterations": iters0}
        for donate in (False, True):
            tag = f"donate={donate}"
            ex = Executor(g, regions=True, donate=donate)
            zero_counts()
            with GraphNodes() as nodes:
                got, first_ms = drive(ex, inp0)
                n_graphs, in_graphs = nodes.read()
            build_calls = counts_now()
            # the first step builds: its eager warm-up and its capture
            check_counts(f"regions {name} {tag} wrapper calls at the "
                         f"first call", build_calls,
                         {k: 2 * c for k, c in per_step.items()})
            check_counts(f"regions {name} {tag} kernel nodes of the "
                         f"{n_graphs} captured graphs", in_graphs, per_step)
            # the kernels write their keys' static buffers: the graphs'
            # memcpy nodes are the forced copies, and no piece copies an
            # output back at its end
            check_memcpys(f"regions {name} {tag}", nodes.memcpys,
                          forced_copies(name))
            memcpys, copy_kernels = nodes.memcpys, nodes.copy_kernels
            copy_back = ex.cache_stats()
            if copy_back["copy_backs"] or copy_back["copy_back_bytes"]:
                raise AssertionError(
                    f"regions {name} {tag}: {copy_back['copy_backs']} "
                    f"copies back of {copy_back['copy_back_bytes']} bytes")
            zero_counts()
            captures = ex.cache_stats()["trace_events"]
            check_bits(f"regions {name} {tag}", got, want0)
            if converging is not None and converging.iterations != iters0:
                raise AssertionError(f"regions {name} {tag}: "
                                     f"{converging.iterations} iterations, "
                                     f"{iters0} eagerly")
            del got
            got, steady_ms = drive(ex, inp0)
            check_bits(f"regions {name} {tag} steady", got, want0)
            del got
            got, whole_ms = whole(ex, inp0)
            check_bits(f"regions {name} {tag} run(steps)", got, want0)
            del got
            got, _ = drive(ex, inp1)
            check_bits(f"regions {name} {tag} seed 1", got, want1)
            del got
            steady_caps = ex.cache_stats()["trace_events"] - captures
            dev_ms, by_kernel, held = busy(ex, inp0)
            if steady_caps:
                raise AssertionError(f"regions {name} {tag}: {steady_caps} "
                                     f"captures in steady state")
            del ex
            before = executable_cache_stats()["trace_events"]
            second = Executor(g, regions=True, donate=donate)
            got, _ = drive(second, inp1)
            check_bits(f"regions {name} {tag} second executor", got, want1)
            second_caps = executable_cache_stats()["trace_events"] - before
            if second_caps:
                raise AssertionError(f"regions {name} {tag}: the second "
                                     f"executor made {second_caps} "
                                     f"captures")
            del got, second
            check_counts(f"regions {name} {tag} wrapper calls after the "
                         f"first call", counts_now(), {})
            unit = "iteration" if converging is not None else "step"
            log(f"regions {name} {tag}: bit for bit equal to regions=False "
                f"({iters0} {unit}s; seed 1: {iters1}); captures: "
                f"{captures} at the first call, {steady_caps} in steady "
                f"state, {second_caps} for a second executor; wrapper "
                f"calls {json.dumps(build_calls)} at the first call, 0 "
                f"after; kernel nodes {json.dumps(in_graphs)} in its "
                f"{n_graphs} graphs, memcpy nodes {len(memcpys)} of "
                f"{sum(memcpys)} bytes (the forced copies: "
                f"{forced_summary(name)}), "
                f"{copy_kernels} copy kernels, 0 copies back; ms per "
                f"{unit} (median): eager {eager_ms:.3f}, regions "
                f"{steady_ms:.3f} (first run {first_ms:.3f}); one "
                f"run(state, steps): eager {eager_whole:.3f}, regions "
                f"{whole_ms:.3f} ms per {unit} ({card})")
            wall = steady_ms * (iters0 if converging is not None else 1)
            eager_wall = eager_ms * (iters0 if converging else 1)

            def share(ms, of):
                if ms == 0.0:   # the profiler saw no device activity
                    return "not measured"
                return f"{ms:.4f} ms of {of:.3f} ms ({100 * ms / of:.1f} %)"

            log(f"regions {name} {tag}: device busy "
                f"{share(dev_ms, wall)}; eager "
                f"{share(eager_busy, eager_wall)}; {held} ({card})")
            top(by_kernel)
            row[tag] = {"ms": steady_ms, "whole_ms": whole_ms,
                        "busy_ms": dev_ms, "captures": captures}
        out[name] = row
        del eager, want0, want1, g, inp0, inp1
        clear_executable_cache()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_regions(arch: str, card: str, zero_counts, counts_now) -> dict:
    """The 8 requests of the main path served twice from one set of
    weights: the decode executor eager, then under ``regions=True,
    donate=True``; the token streams must be equal, and each run's
    prefills launch K6 and K7 as phase 3's do.  Returns tokens/s and
    decode ms per step both ways."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import clear_executable_cache
    from repro_torch.models.lm import init_lm
    from repro_torch.runtime.batcher import Batcher

    dev = torch.device("cuda")
    cfg = configs.get(arch)
    if arch in MOE_LAYERS:
        log(f"{arch}: reduced: {MOE_LAYERS[arch]} of {cfg.n_layers} layers "
            f"(the published width; the depth cut to fit the card)")
        cfg = cfg.with_(n_layers=MOE_LAYERS[arch])
    kinds = [k for _ in range(cfg.layer_groups()[0])
             for k in cfg.layer_groups()[1]] + list(cfg.layer_groups()[2])
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LM_PROMPTS]
    expect = {"flash_attention": kinds.count("A") * len(prompts),
              "ssd_intra_chunk": kinds.count("M") * len(prompts)}
    runs = {}
    for mode, opts in (("eager", {"regions": False}),
                       ("regions", {"regions": True, "donate": True})):
        batcher = Batcher(cfg, params, batch=LM_SLOTS, max_seq=LM_MAX_SEQ,
                          log=log, executor_opts=opts)
        reqs = [batcher.submit(p, max_new_tokens=LM_GEN) for p in prompts]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with GraphNodes() as nodes:
            batcher.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_graphs, _ = nodes.read()
        counts = counts_now()
        if mode == "regions":
            # each layer's cache is written in place (its token's k/v, its
            # SSD state): no copy in the captured graph, and no copy back
            # at its end, comes near one layer's cache
            layer = min(sum(batcher.state[t.name].numel()
                            * batcher.state[t.name].element_size()
                            for t in slot.tensors)
                        for slot in batcher.dg.slots)
            back = batcher.cache_stats()["decode"]
            biggest = max(nodes.memcpys, default=0)
            if n_graphs != 1 or biggest >= layer \
                    or back["copy_back_bytes"] >= layer:
                raise AssertionError(
                    f"regions serve {arch}: {n_graphs} graphs, largest "
                    f"memcpy {biggest} B, {back['copy_back_bytes']} B "
                    f"copied back a step, one layer's cache {layer} B")
            log(f"regions serve {arch}: the decode graph holds "
                f"{len(nodes.memcpys)} memcpy nodes of {sum(nodes.memcpys)} "
                f"bytes (largest {biggest}) and {nodes.copy_kernels} copy "
                f"kernels; {back['copy_backs']} copies back of "
                f"{back['copy_back_bytes']} bytes a step; one layer's cache "
                f"{layer} bytes: no cache is copied")
        check_counts(f"regions serve {arch} {mode}", counts, expect)
        harvests = sorted({t for r in reqs for t in r.token_times[1:]})
        step_ms = statistics.median(
            (b - a) * 1e3 for a, b in zip(harvests, harvests[1:]))
        n_tok = sum(len(r.generated) for r in reqs)
        # one more decode step alone (every slot retired by now), host
        # clock, then the same step under the profiler
        ex, state = batcher.executor, batcher.state
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state = ex(state)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        by_kernel = device_time_by_kernel(lambda: ex(state))
        dev_ms = sum(us for us, _ in by_kernel.values()) / 1e3
        stats = batcher.cache_stats()["decode"]
        runs[mode] = {"streams": [list(r.generated) for r in reqs],
                      "tok_s": n_tok / wall, "step_ms": step_ms,
                      "alone_ms": statistics.median(walls),
                      "busy_ms": dev_ms, "stats": stats}
        log(f"regions serve {arch} {mode}: {n_tok} tokens in {wall:.3f} s "
            f"= {n_tok / wall:.1f} tokens/s; decode {step_ms:.3f} ms per "
            f"step (median gap between harvests, 4 slots); one decode step "
            f"alone {runs[mode]['alone_ms']:.3f} ms wall, device busy "
            f"{f'{dev_ms:.3f} ms' if dev_ms else 'not measured'}; "
            f"executor {json.dumps(stats)}; launches {json.dumps(counts)} "
            f"({card})")
        del batcher, ex, state
        gc.collect()
        torch.cuda.empty_cache()
    if runs["regions"]["streams"] != runs["eager"]["streams"]:
        raise AssertionError(f"regions serve {arch}: token streams under "
                             f"regions=True differ from the eager "
                             f"batcher's")
    if runs["regions"]["stats"]["trace_events"] != 1:
        raise AssertionError(f"regions serve {arch}: "
                             f"{runs['regions']['stats']['trace_events']} "
                             f"captures of the decode graph, expected 1")
    log(f"regions serve {arch}: the {len(prompts)} token streams under "
        f"regions=True, donate=True equal the eager batcher's")
    del params
    clear_executable_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# phase 3c: the particle step with a host diagnostic; async against sync.
# The gate is the JAX package's benchmarks/overlap_gain.py's: with the host
# time a step calibrated to the synchronous step's own time, async regions
# must be at least this much faster
ASYNC_GATE = 1.3
ASYNC_REPS = 3          # timed runs of PARTICLE_STEPS steps each way
ASYNC_PROFILED = 10     # steps of the profiled run of each way
HOST_TIMEOUT_S = 0.5    # the watchdog's limit, and its delay fault's 2 s
HUNG_S = 2.0


class Diagnostic:
    """The host node's callable: keeps each step's ``(t, vmax)`` and the
    threads it ran on, and sleeps ``host_s`` a call (logging or metrics
    I/O), keeping how long each sleep took on the host clock.  An object,
    so the plan signature keys it by identity."""

    def __init__(self):
        self.log: list = []
        self.threads: set = set()
        self.slept: list = []
        self.host_s = 0.0

    def reset(self) -> None:
        self.log = []
        self.threads = set()
        self.slept = []

    def __call__(self, t: float, vmax: float) -> None:
        import threading

        self.log.append((t, vmax))
        self.threads.add(threading.current_thread().name)
        if self.host_s:
            t0 = time.perf_counter()
            time.sleep(self.host_s)
            self.slept.append(time.perf_counter() - t0)


def async_phase(card: str, zero_counts, counts_now) -> dict:
    """Async regions on the card, over the particle step with a host
    diagnostic at 2^24 particles per species.  Equality: eager, and
    ``regions=True`` with ``async_regions`` True and False under both
    ``donate``s, each regions run from a cold executable cache: final
    states bit for bit, equal ``(t, vmax)`` logs, callbacks on the pool or
    on the main thread.  Overlap: ms per step sync and async, in turns,
    without and with a host time calibrated to the sync step, the device
    busy share, the gate.  Faults: the ladder down to ``sequential`` and back with
    zero new captures, and the watchdog.  Returns the numbers."""
    import threading

    import torch

    from repro_torch import workloads
    from repro_torch.core import (Executor, HostTimeoutError,
                                  clear_executable_cache,
                                  executable_cache_stats)
    from repro_torch.runtime.faults import (Fault, FaultPlan, RetryPolicy,
                                            fault_scope)

    diag = Diagnostic()
    g, _, _ = workloads.build_particle_diagnostic_graph(PARTICLE_N, diag)
    _, inp, _, _ = regions_graph("particle_step", 0)
    steps = PARTICLE_STEPS
    per_step = {"particle_update": 2, "saxpy_record": 1,
                "nan_ignoring_extremum": 1}
    regions = [r.kind for r in Executor(g, regions=True).plan.regions]
    if regions != ["device", "host", "device"]:
        raise AssertionError(f"async: the plan's regions are {regions}")

    def whole(ex):
        """One ``run(state, steps)``: the state and wall ms per step."""
        state = ex.init_state(**inp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ex.run(state, steps)
        torch.cuda.synchronize()
        return state, (time.perf_counter() - t0) * 1e3 / steps

    # -- equality, each regions run from a cold cache
    eager = Executor(g, regions=False)
    diag.reset()
    zero_counts()
    want, _ = whole(eager)
    check_counts("async eager wrapper calls", counts_now(),
                 {k: n * steps for k, n in per_step.items()})
    want_log = diag.log
    if diag.threads != {"MainThread"} or len(want_log) != steps:
        raise AssertionError(f"async eager: {len(want_log)} callbacks on "
                             f"{diag.threads}")
    del eager
    keep = {}
    for donate in (False, True):
        for mode in (True, False):
            tag = f"{'async' if mode else 'sync'} donate={donate}"
            clear_executable_cache()
            ex = Executor(g, regions=True, donate=donate,
                          async_regions=mode)
            diag.reset()
            zero_counts()
            got, first_ms = whole(ex)
            # the build: each piece's eager warm-up and its capture
            check_counts(f"async {tag} wrapper calls", counts_now(),
                         {k: 2 * n for k, n in per_step.items()})
            check_bits(f"async {tag}", got, want)
            if diag.log != want_log:
                raise AssertionError(f"async {tag}: the logged (t, vmax) "
                                     f"differ from the eager run's")
            placed = (all(t.startswith("ripple-host") for t in diag.threads)
                      if mode else diag.threads == {"MainThread"})
            if not placed:
                raise AssertionError(f"async {tag}: callbacks ran on "
                                     f"{sorted(diag.threads)}")
            stats = dict(ex.async_stats)
            log(f"async {tag}: bit for bit equal to the eager run, "
                f"{steps} logged (t, vmax) equal, callbacks on "
                f"{sorted(diag.threads)}; captures "
                f"{ex.cache_stats()['trace_events']} from a cold cache; "
                f"first run {first_ms:.3f} ms per step; {json.dumps(stats)}")
            del got
            if donate:
                keep[mode] = ex
            del ex
    # -- overlap: ms per step both ways, without and with the host time;
    # the two ways take turns (sync, async, async, sync, ...), so that the
    # host's drift from one run to the next (its sleeps' overshoot moves
    # by a few tenths of a ms within a minute) falls on both alike
    times = {}
    for host in ("no host time", "host time"):
        if host == "host time":
            # the host time a step: the synchronous step's own
            diag.host_s = times[("no host time", False)] / 1e3
        runs = {False: [], True: []}
        slept_s = {False: [], True: []}
        before = {mode: dict(ex.async_stats) for mode, ex in keep.items()}
        for i in range(ASYNC_REPS):
            for mode in ((False, True) if i % 2 == 0 else (True, False)):
                diag.reset()
                got, ms = whole(keep[mode])
                runs[mode].append(ms)
                slept_s[mode] += diag.slept
                del got
        for mode in (False, True):
            ex = keep[mode]
            times[(host, mode)] = statistics.median(runs[mode])
            # the dispatcher's own time a step: the wall less its waits
            # on callbacks (the in-flight cap of 32, the final drain)
            waited = (ex.async_stats["wait_s"] - before[mode]["wait_s"]) \
                * 1e3 / (ASYNC_REPS * steps)
            snap = (ex.async_stats["snapshot_bytes"]
                    - before[mode]["snapshot_bytes"]) / (ASYNC_REPS * steps)
            state = ex.init_state(**inp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            by_kernel = device_time_by_kernel(
                lambda: ex.run(state, ASYNC_PROFILED))
            prof_ms = (time.perf_counter() - t0) * 1e3 / ASYNC_PROFILED
            dev_ms = sum(us for us, _ in by_kernel.values()) / 1e3 \
                / ASYNC_PROFILED
            busy = ("not measured" if dev_ms == 0.0 else
                    f"{dev_ms:.4f} ms a step of {times[(host, mode)]:.3f} "
                    f"({100 * dev_ms / times[(host, mode)]:.1f} %; the "
                    f"profiled run {prof_ms:.3f} ms a step)")
            times[(host, mode, "busy")] = dev_ms
            slept = ("" if not slept_s[mode] else
                     f"; a sleep of {1e3 * diag.host_s:.3f} ms took "
                     f"{1e3 * statistics.median(slept_s[mode]):.3f} ms "
                     f"(median) on the callback's thread")
            waits = (f"; the dispatcher waited {waited:.3f} ms a step on "
                     f"callbacks, snapshots {snap:.0f} bytes a step, "
                     f"{ex.async_stats['peak_inflight']} in flight at most"
                     if mode else "")
            log(f"async overlap {'async' if mode else 'sync'}, {host} "
                f"({1e3 * diag.host_s:.3f} ms a callback): ms per step "
                f"{times[(host, mode)]:.3f} (runs in turns "
                f"{', '.join(f'{ms:.3f}' for ms in runs[mode])}); device "
                f"busy {busy}{slept}{waits} ({card})")
    diag.host_s = 0.0
    gain = times[("host time", False)] / times[("host time", True)]
    log(f"async overlap: sync/async with the host time {gain:.2f}x "
        f"(gate {ASYNC_GATE}x), without "
        f"{times[('no host time', False)] / times[('no host time', True)]:.2f}x"
        f" ({card})")
    for mode, ex in keep.items():
        if ex.ladder_level != 0 or ex.plan.degradations:
            raise AssertionError(f"async: a timed executor ended at ladder "
                                 f"level {ex.ladder_level}: "
                                 f"{ex.plan.describe_degradations()}")
    if gain < ASYNC_GATE:
        raise AssertionError(f"async overlap: {gain:.2f}x, under the "
                             f"{ASYNC_GATE}x gate")
    del keep
    # -- faults and the ladder: down to sequential, back with no capture
    clear_executable_cache()
    ex = Executor(g, regions=True, donate=True, demote_after=1,
                  promote_after=2)
    check_bits("async ladder level 0", whole(ex)[0], want)
    caps0 = executable_cache_stats()["trace_events"]
    plan = FaultPlan([Fault("executor.region", nth=0, times=2)])
    retry = RetryPolicy(max_retries=4, base_delay=0.0, sleep=lambda d: None)
    with fault_scope(plan):
        got = retry.call(lambda: whole(ex)[0])
    moves = [(e.action, e.frm, e.to, e.site) for e in ex.plan.degradations]
    if not plan.exhausted() or ex.ladder_level != 2 \
            or ex.schedule != "sequential" or moves != [
                ("demote", "async_regions", "sync", "executor.region"),
                ("demote", "sync", "sequential", "executor.region")]:
        raise AssertionError(f"async ladder: level {ex.ladder_level}, "
                             f"{moves}; {plan.report()}")
    check_bits("async ladder at sequential", got, want)
    del got
    caps_seq = executable_cache_stats()["trace_events"] - caps0
    for n in range(3):
        got, _ = whole(ex)
        check_bits(f"async ladder clean pass {n + 1}", got, want)
        del got
    caps_back = executable_cache_stats()["trace_events"] - caps0 - caps_seq
    if ex.ladder_level != 0 or caps_back or not ex.async_regions:
        raise AssertionError(f"async ladder: level {ex.ladder_level} after "
                             f"the clean passes, {caps_back} captures")
    text = ex.plan.describe()
    lines = [ln for ln in text.splitlines() if ln.startswith("ladder ")]
    if len(lines) != 4:
        raise AssertionError(f"async ladder: plan.describe() shows {lines}")
    log(f"async ladder: demoted async_regions -> sync -> sequential "
        f"({plan.report().splitlines()[1:]}), bit for bit equal; the "
        f"sequential plan took {caps_seq} captures; back at level 0 with "
        f"{caps_back} new captures; plan.describe():")
    for ln in lines:
        log(f"  {ln}")
    del ex
    # -- the watchdog: a hung callback past host_timeout
    wd = Executor(g, regions=True, donate=True, host_timeout=HOST_TIMEOUT_S)
    check_bits("async watchdog warm", whole(wd)[0], want)
    caps = executable_cache_stats()["trace_events"]
    plan = FaultPlan([Fault("executor.host", nth=0, kind="delay",
                            delay_s=HUNG_S)])
    t0 = time.perf_counter()
    raised = None
    with fault_scope(plan):
        try:
            wd.run(wd.init_state(**inp), steps)
        except HostTimeoutError as exc:
            raised = exc
    dt = time.perf_counter() - t0
    if raised is None or dt >= 1.0:
        raise AssertionError(f"async watchdog: {raised!r} after {dt:.3f} s")
    got, _ = whole(wd)
    check_bits("async watchdog next call", got, want)
    new_caps = executable_cache_stats()["trace_events"] - caps
    if new_caps or wd.ladder_level:
        raise AssertionError(f"async watchdog: {new_caps} captures, level "
                             f"{wd.ladder_level} on the next call")
    log(f"async watchdog: HostTimeoutError after {dt:.3f} s (host_timeout "
        f"{HOST_TIMEOUT_S} s, callback hung {HUNG_S} s); the next call bit "
        f"for bit equal with {new_caps} new captures")
    del got, wd, want
    clear_executable_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return {"times": {f"{h} {'async' if m else 'sync'}": v
                      for (h, m, *rest), v in times.items() if not rest},
            "gain": gain, "ladder_captures": caps_seq}



def mesh_regions(what: str, make_ex, init: dict, steps: int, read_out,
                 check, kernels: dict, card: str, zero_counts,
                 counts_now) -> dict:
    """Phase 3d under ``regions=True``, both ``donate``s: ``make_ex(donate)``
    builds the executor; its first step is one capture holding
    ``kernels`` as kernel nodes (the wrappers called twice each at the
    build, never after); ``steps`` steps in all end at ``check``'s
    state (against the eager mesh run); one step more is profiled; steady
    state and a second executor over an equal graph (the first's kept
    alive, which keeps its cache entry) make no capture, and the second's
    first step equals the first's bit for bit.  Returns ms per step and
    device ms by ``donate``."""
    import torch

    from repro_torch.core import (clear_executable_cache,
                                  executable_cache_stats)

    rows = {}
    for donate in (False, True):
        tag = f"{what} regions donate={donate}"
        ex = make_ex(donate)
        zero_counts()
        with GraphNodes() as nodes:
            state = ex.run(ex.init_state(**init), 1)
            n_graphs, in_graphs = nodes.read()
        caps = ex.cache_stats()["trace_events"]
        if n_graphs != 1 or caps != 1:
            raise AssertionError(f"{tag}: {n_graphs} graphs, {caps} "
                                 f"captures at the first step, expected 1")
        check_counts(f"{tag} kernel nodes", in_graphs, kernels)
        check_counts(f"{tag} wrapper calls at the build", counts_now(),
                     {k: 2 * n for k, n in kernels.items()})
        first = {k: v.clone() for k, v in read_out(ex, state).items()}
        zero_counts()
        state, ms = run_steps(ex, state, steps - 1)
        note = check(read_out(ex, state))
        by_kernel = device_time_by_kernel(lambda: ex.run(state, 1),
                                          warmup=1)
        busy = sum(us for us, _ in by_kernel.values()) / 1e3
        check_counts(f"{tag} wrapper calls after the build", counts_now(),
                     {})
        steady = ex.cache_stats()["trace_events"] - caps
        memcpys, copies = len(nodes.memcpys), nodes.copy_kernels
        # the entry lives while a graph it was built from lives: a
        # second executor over an equal graph reuses it
        graph = ex.graph
        del ex, state
        before = executable_cache_stats()["trace_events"]
        second = make_ex(donate)
        got = read_out(second, second.run(second.init_state(**init), 1))
        for k, v in first.items():
            if not bits_equal(got[k], v):
                raise AssertionError(f"{tag}: the second executor's {k} "
                                     f"differs from the first's")
        second_caps = executable_cache_stats()["trace_events"] - before
        if steady or second_caps:
            raise AssertionError(f"{tag}: {steady} captures in steady "
                                 f"state, {second_caps} for a second "
                                 f"executor")
        del second, got, first, graph
        clear_executable_cache()
        torch.cuda.empty_cache()
        log(f"{tag}: {note}; one capture, kernel nodes "
            f"{json.dumps(in_graphs)}, {memcpys} memcpy nodes and {copies} "
            f"copy kernels in the graph; 0 captures in steady state and for "
            f"a second executor; {ms:.3f} ms per step (median of "
            f"{steps - 1}), device {busy:.4f} ms in a step, busy "
            f"{100 * busy / ms:.1f} % ({card})")
        rows[donate] = {"ms": ms, "busy_ms": busy}
    return rows


def eikonal_mesh_regions(card: str, mesh, eik: dict, want, iters: int,
                         zero_counts, counts_now) -> dict:
    """The eikonal solve on ``mesh`` under ``regions=True``, both
    ``donate``s: the loop body is one capture holding K5 and the max's
    read once per shard;
    the solve takes ``iters`` iterations and ends at the eager mesh run's
    phi (``want``) bit for bit; a second solve and a second executor over
    the same graph capture nothing.  Returns solve seconds and device ms
    by ``donate``."""
    import torch

    from repro_torch import workloads
    from repro_torch.core import (Executor, clear_executable_cache,
                                  executable_cache_stats)

    rows = {}
    for donate in (False, True):
        tag = f"mesh eikonal regions donate={donate}"
        g, (phi_t, _), conv = workloads.build_eikonal_graph(
            EIK_N, inner=EIK_INNER, block=EIK_BLOCK, max_iters=4 * EIK_N,
            mesh=mesh)
        ex = Executor(g, mesh=mesh, regions=True, donate=donate)

        def solve(e):
            state = e.init_state(**eik)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = e(state)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if conv.iterations != iters:
                raise AssertionError(f"{tag}: {conv.iterations} "
                                     f"iterations, {iters} eagerly")
            if not bits_equal(e.read(state, phi_t), want):
                raise AssertionError(f"{tag}: phi differs from the eager "
                                     f"mesh solve's")
            return secs

        zero_counts()
        with GraphNodes() as nodes:
            solve(ex)
            n_graphs, in_graphs = nodes.read()
        caps = ex.cache_stats()["trace_events"]
        if n_graphs != 1 or caps != 1:
            raise AssertionError(f"{tag}: {n_graphs} graphs, {caps} "
                                 f"captures, expected the loop body's 1")
        per_iter = {"eikonal_fim": mesh.size,
                    "nan_ignoring_extremum": mesh.size}
        check_counts(f"{tag} kernel nodes", in_graphs, per_iter)
        check_counts(f"{tag} wrapper calls at the build", counts_now(),
                     {k: 2 * n for k, n in per_iter.items()})
        zero_counts()
        secs = solve(ex)
        by_kernel = device_time_by_kernel(lambda: ex(ex.init_state(**eik)))
        busy = sum(us for us, _ in by_kernel.values()) / 1e3
        check_counts(f"{tag} wrapper calls after the build", counts_now(),
                     {})
        steady = ex.cache_stats()["trace_events"] - caps
        memcpys, copies = len(nodes.memcpys), nodes.copy_kernels
        del ex
        before = executable_cache_stats()["trace_events"]
        second = Executor(g, mesh=mesh, regions=True, donate=donate)
        solve(second)
        second_caps = executable_cache_stats()["trace_events"] - before
        if steady or second_caps:
            raise AssertionError(f"{tag}: {steady} captures in steady "
                                 f"state, {second_caps} for a second "
                                 f"executor")
        del second, g
        clear_executable_cache()
        torch.cuda.empty_cache()
        log(f"{tag}: {iters} iterations, phi bit for bit the eager mesh "
            f"solve's; one capture (the body: kernel nodes "
            f"{json.dumps(in_graphs)}, {memcpys} memcpy nodes, {copies} "
            f"copy kernels); 0 captures in steady state and for a second "
            f"executor; solve {secs:.3f} s ({1e3 * secs / iters:.3f} ms per "
            f"iteration), device {busy:.3f} ms in all "
            f"({busy / iters:.4f} per iteration), busy "
            f"{100 * busy / (1e3 * secs):.1f} % ({card})")
        rows[donate] = {"s": secs, "busy_ms": busy}
    return rows


def mesh_phase(card: str, zero_counts, counts_now, eik: dict) -> dict:
    """Phase 3d: the flux graph, the eikonal solve and the Euler solver on
    a mesh of shards on cuda:0, against their unsharded runs.  Returns the
    numbers and the K4/K5 and max launches of the mesh runs."""
    import torch

    from repro_torch import workloads
    from repro_torch.core import Executor, halo as halo_lib, make_mesh
    from repro_torch.physics.euler import RHO, shock_bubble_init

    dev = torch.device("cuda")
    mesh22 = make_mesh((2, 2), ("gx", "gy"), devices=["cuda:0"] * 4)
    mesh4 = make_mesh((4,), ("gy",), devices=["cuda:0"] * 4)
    out = {"launches": {"flux_difference": 0, "eikonal_fim": 0,
                        "nan_ignoring_extremum": 0}}

    copied = []
    transfer = halo_lib._transfer

    def counting_transfer(x, device):
        copied.append(x.numel() * x.element_size())
        return transfer(x, device)

    # -- flux: unsharded, mesh sync, mesh overlap --------------------------
    u0 = shock_bubble_init(FLUX_N, FLUX_N, device=dev)
    flux = {}
    for tag, mesh, overlap in (("unsharded", None, False),
                               ("mesh sync", mesh22, False),
                               ("mesh overlap", mesh22, True)):
        g, (_, f_t) = workloads.build_flux_graph(
            FLUX_N, FLUX_N, lam_x=FLUX_LAM, lam_y=FLUX_LAM, mesh=mesh,
            overlap=overlap)
        ex = Executor(g, mesh=mesh, regions=False)
        state = ex.init_state(u=u0)
        zero_counts()
        state, ms = run_steps(ex, state, FLUX_STEPS)
        per_step = 1 if mesh is None else 4 * (5 if overlap else 1)
        check_counts(f"mesh flux {tag} launches", counts_now(),
                     {"flux_difference": FLUX_STEPS * per_step})
        if mesh is not None:
            out["launches"]["flux_difference"] += FLUX_STEPS * per_step
            ht = ex.plan.halo_transfers
            if ex.plan.overlap_fallbacks:
                raise AssertionError(f"mesh flux {tag}: fallbacks "
                                     f"{ex.plan.overlap_fallbacks}")
            for axis in ("gx", "gy"):
                if not any(h.mesh_axis == axis and h.overlapped == overlap
                           for h in ht):
                    raise AssertionError(f"mesh flux {tag}: no "
                                         f"{'overlapped ' if overlap else ''}"
                                         f"block over {axis}")
            if not any(len(h.block) == 2 and h.overlapped == overlap
                       for h in ht):
                raise AssertionError(f"mesh flux {tag}: no corner block")
        # one more step: the halo bytes copied, then its device time
        copied.clear()
        halo_lib._transfer = counting_transfer
        try:
            ex.run(state, 1)
        finally:
            halo_lib._transfer = transfer
        torch.cuda.synchronize()
        by_kernel = device_time_by_kernel(lambda: ex.run(state, 1),
                                          warmup=1)
        busy = sum(us for us, _ in by_kernel.values()) / 1e3
        du = ex.read(state, f_t).data
        flux[tag] = dict(ms=ms, busy_ms=busy, copied=sum(copied),
                         copies=len(copied), du=du)
        log(f"mesh flux {tag}: {ms:.3f} ms per step (median of "
            f"{FLUX_STEPS}), K4 {per_step} launches a step, halo copies "
            f"{len(copied)} of {sum(copied)} bytes a step; device "
            f"{busy:.4f} ms in a step, busy {100 * busy / ms:.1f} % "
            f"({card})")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        for name, (us, count) in top:
            log(f"  {us / 1e3:.4f} ms, {count} launches: {name[:90]}")
        del ex, state

        def flux_check(got, _du=du):
            if not bits_equal(got["du"], _du):
                raise AssertionError("du differs from the eager mesh run's")
            return "du bit for bit the eager run's"

        flux[tag]["regions"] = mesh_regions(
            f"mesh flux {tag}",
            lambda donate, _g=g, _m=mesh: Executor(
                _g, mesh=_m, regions=True, donate=donate),
            {"u": u0}, FLUX_STEPS,
            lambda e, st, _t=f_t: {"du": e.read(st, _t).data}, flux_check,
            {"flux_difference": per_step}, card, zero_counts, counts_now)
        del g
    want = flux["unsharded"]["du"]
    for tag in ("mesh sync", "mesh overlap"):
        got = flux[tag]["du"]
        if bits_equal(got, want):
            log(f"mesh flux {tag}: du bit for bit the unsharded K4 run's")
        else:
            err = max_err(got, want, FLUX_TOL["float32"],
                          f"mesh flux {tag} vs unsharded")
            log(f"mesh flux {tag}: du NOT bit for bit; max |diff| "
                f"{err:.3e} within {FLUX_TOL['float32']}")
    out["flux"] = {k: {f: v for f, v in r.items() if f != "du"}
                   for k, r in flux.items()}
    del flux, want, u0
    torch.cuda.empty_cache()

    # -- eikonal: unsharded and on the (2, 2) mesh, synchronous ------------
    eik_runs = {}
    for tag, mesh in (("unsharded", None), ("mesh sync", mesh22)):
        g, (phi_t, _), conv = workloads.build_eikonal_graph(
            EIK_N, inner=EIK_INNER, block=EIK_BLOCK, max_iters=4 * EIK_N,
            mesh=mesh)
        ex = Executor(g, mesh=mesh, regions=False)
        state = ex.init_state(**eik)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ex(state)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        iters = conv.iterations
        per_iter = 1 if mesh is None else 4
        check_counts(f"mesh eikonal {tag} launches", counts_now(),
                     {"eikonal_fim": per_iter * iters,
                      "nan_ignoring_extremum": per_iter * iters})
        if mesh is not None:
            out["launches"]["eikonal_fim"] += per_iter * iters
            out["launches"]["nan_ignoring_extremum"] += per_iter * iters
        eik_runs[tag] = (ex.read(state, phi_t), iters, secs)
        log(f"mesh eikonal {tag}: {iters} iterations, {secs:.3f} s "
            f"({1e3 * secs / iters:.3f} ms per iteration) ({card})")
        del ex, state, g
    (phi, iters, secs), (phi0, iters0, secs0) = (eik_runs["mesh sync"],
                                                 eik_runs["unsharded"])
    if not 0 < iters == iters0:
        raise AssertionError(f"mesh eikonal: {iters} iterations on the "
                             f"mesh, {iters0} unsharded")
    if not bits_equal(phi, phi0):
        err = max_err(phi, phi0, EIK_TOL["float32"][0],
                      "mesh eikonal vs unsharded",
                      rtol=EIK_TOL["float32"][1])
        log(f"mesh eikonal: phi NOT bit for bit; max |diff| {err:.3e}")
    else:
        log("mesh eikonal: phi bit for bit the unsharded solve's, "
            f"{iters} iterations both")
    out["eikonal"] = {"iterations": iters, "mesh_s": secs,
                      "unsharded_s": secs0,
                      "regions": eikonal_mesh_regions(
                          card, mesh22, eik, phi, iters, zero_counts,
                          counts_now)}
    del eik_runs, phi, phi0
    torch.cuda.empty_cache()

    # -- the Euler solver: unsharded, (4,) over gy, (2, 2) overlapped ------
    U0 = shock_bubble_init(EULER_NX, EULER_NY, device=dev)
    dx, dy = 2.0 / EULER_NX, 1.0 / EULER_NY
    mass0 = float(U0[RHO].double().sum()) * dx * dy
    out["euler"] = {}
    for unsplit in (False, True):
        runs = {}
        for tag, mesh, overlap in (("unsharded", None, False),
                                   ("(4,) gy", mesh4, False),
                                   ("(2, 2) overlap", mesh22, True)):
            ex, u = workloads.build_euler_solver(
                EULER_NX, EULER_NY, mesh=mesh, overlap=overlap,
                unsplit=unsplit, regions=False)
            if ex.plan.overlap_fallbacks:
                raise AssertionError(f"euler {tag}: fallbacks "
                                     f"{ex.plan.overlap_fallbacks}")
            state = ex.init_state(u=U0)
            state, ms = run_steps(ex, state, EULER_STEPS)
            U = ex.read(state, u).data
            drift = abs(float(U[RHO].double().sum()) * dx * dy - mass0) \
                / mass0
            runs[tag] = (U, state["smax"], float(state["mass"]), ms)
            log(f"euler {'unsplit' if unsplit else 'split'} {tag}: "
                f"{ms:.3f} ms per step (median), smax "
                f"{float(state['smax']):.6f}, "
                f"mass drift {drift:.3e} (graph's mass "
                f"{float(state['mass']):.6f}) ({card})")
            del ex, state
        U_ref, smax_ref, mass_ref, _ = runs["unsharded"]
        kind = "unsplit" if unsplit else "split"
        out["euler"][f"{kind} regions"] = {}
        for tag, mesh, overlap in (("(4,) gy", mesh4, False),
                                   ("(2, 2) overlap", mesh22, True)):
            U, smax = runs[tag][0], runs[tag][1]

            def euler_check(got, _U=U, _smax=smax, _tag=tag):
                err = max_err(got["u"], _U, 1e-6,
                              f"euler {_tag} regions vs eager", rtol=1e-5)
                if not bits_equal(got["smax"], _smax):
                    raise AssertionError(f"euler {_tag} regions: smax "
                                         f"{float(got['smax'])} against "
                                         f"{float(_smax)}")
                same = ("bit for bit" if bits_equal(got["u"], _U)
                        else f"max |diff| {err:.3e}")
                return f"u {same} against the eager mesh run's, smax equal"

            out["euler"][f"{kind} regions"][tag] = mesh_regions(
                f"euler {kind} {tag}",
                lambda donate, _m=mesh, _o=overlap: workloads
                .build_euler_solver(EULER_NX, EULER_NY, mesh=_m,
                                    overlap=_o, unsplit=unsplit,
                                    regions=True, donate=donate)[0],
                {"u": U0}, EULER_STEPS,
                lambda e, st: {"u": e.read(st, e.tensors["u"]).data,
                               "smax": st["smax"]},
                euler_check, {"nan_ignoring_extremum": mesh.size}, card,
                zero_counts, counts_now)
        for tag in ("(4,) gy", "(2, 2) overlap"):
            U, smax, mass, ms = runs[tag]
            err = max_err(U, U_ref, 1e-6, f"euler {tag} vs unsharded",
                          rtol=1e-5)
            if not bits_equal(smax, smax_ref):
                raise AssertionError(f"euler {tag}: smax {float(smax)} "
                                     f"against {float(smax_ref)}")
            log(f"euler {'unsplit' if unsplit else 'split'} {tag}: state "
                f"max |diff| {err:.3e} from unsharded, smax equal, mass "
                f"{mass:.9g} against {mass_ref:.9g} "
                f"(sum folded per shard)")
        out["euler"]["unsplit" if unsplit else "split"] = {
            tag: r[3] for tag, r in runs.items()}
        del runs, U_ref
    del U0
    torch.cuda.empty_cache()
    return out


def load_example(name: str):
    """The module of ``examples/{name}.py`` (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(card: str, zero_counts, counts_now) -> dict:
    """Phase 3e: measured tuning on a mesh and the paper's examples on the
    port, all at the executor's defaults.  The flux graph at 4096^2 on a
    (2, 2) mesh of the card under ``tune="auto"`` and an empty tuning
    cache (``tune_graph``: the tuned state against the heuristic plan's,
    bit for bit unless a tile changed; a second construction loads the
    decision with zero measurements); then ``examples/particles_torch.py``
    at 2^24 particles a species for 100 steps (its closed-form check), and
    ``examples/euler2d_torch.py`` at 1024 x 512 for 20 steps on one shard
    and on ``--devices 4 --px 2 --overlap``: the four-shard state within
    rtol 1e-5, atol 1e-6 of the one-shard run's, every printed smax and
    rho range equal.  Returns the readings and the launches."""
    import torch

    from repro_torch import workloads
    from repro_torch.core import clear_executable_cache, make_mesh
    from repro_torch.physics.euler import shock_bubble_init
    from repro_torch.tuning import cache as tune_cache

    out = {"launches": {}}
    u0 = shock_bubble_init(FLUX_N, FLUX_N, device=torch.device("cuda"))

    def add(counts):
        for k, n in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + n

    # -- the (2, 2) flux mesh under tune="auto", from an empty cache -------
    os.environ["REPRO_TUNE_CACHE"] = TUNE_CACHE
    shutil.rmtree(TUNE_CACHE, ignore_errors=True)
    tune_cache.clear_memo()
    mesh = make_mesh((2, 2), ("gx", "gy"), devices=["cuda:0"] * 4)
    g, _ = workloads.build_flux_graph(FLUX_N, FLUX_N, lam_x=FLUX_LAM,
                                      lam_y=FLUX_LAM, mesh=mesh)
    run = tune_graph("mesh flux (2, 2)", g, {"u": u0},
                     {"u": 0.0, "flux": FLUX_TOL["float32"]}, card,
                     zero_counts, counts_now, mesh=mesh, strict=True)
    # one K4 launch a shard a step: each capture calls the wrapper twice
    # a shard (the warm-up and the capture)
    check_counts("tune mesh flux (2, 2) wrapper calls", run["counts"],
                 {"flux_difference": 2 * mesh.size * run["captures"]})
    add(run["counts"])
    out["tune"] = {k: run[k] for k in ("search_s", "base_ms", "tuned_ms",
                                       "captures")}
    dec = run["decision"]
    out["tune"].update(proposed=dec.proposed, measured=dec.measured,
                       winner=dec.describe().splitlines()[1:3])
    del g, run, dec, u0
    clear_executable_cache()
    gc.collect()
    torch.cuda.empty_cache()

    # -- examples/particles_torch.py, 2^24 a species, 100 steps ------------
    particles = load_example("particles_torch")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = particles.main(["--n", str(PARTICLE_N), "--steps",
                          str(PARTICLE_STEPS)])
    counts = counts_now()
    check_counts("examples/particles_torch.py wrapper calls", counts,
                 {k: 2 * n for k, n in
                  REGION_KERNELS["particle_step"].items()})
    add(counts)
    out["particles"] = {"first_s": res["first_s"], "step_ms": res["step_ms"],
                        "vmax": res["vmax"]}
    log(f"examples/particles_torch.py --n {PARTICLE_N} --steps "
        f"{PARTICLE_STEPS}: closed form holds (rtol, atol 1e-4), vmax "
        f"{res['vmax']:.4f}; first step (the build) {res['first_s']:.3f} s, "
        f"then {res['step_ms']:.3f} ms per step; wrapper calls "
        f"{json.dumps(counts)} (the build); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    del res
    clear_executable_cache()
    gc.collect()
    torch.cuda.empty_cache()

    # -- examples/euler2d_torch.py, 1024 x 512, 20 steps, 1 and 4 shards ---
    euler = load_example("euler2d_torch")
    size = ["--nx", str(EULER_NX), "--ny", str(EULER_NY), "--steps",
            str(EULER_STEPS)]
    one = euler.main(size)
    four = euler.main(size + ["--devices", "4", "--px", "2", "--overlap"])
    err = max_err(four["U"], one["U"], 1e-6,
                  "examples/euler2d_torch.py --devices 4 vs 1", rtol=1e-5)
    for a, b in zip(four["rows"], one["rows"]):
        if (a["smax"], a["rho_min"], a["rho_max"]) != \
                (b["smax"], b["rho_min"], b["rho_max"]):
            raise AssertionError(f"examples/euler2d_torch.py: step "
                                 f"{a['step']} prints {a} on four shards, "
                                 f"{b} on one")
    if four["executor"].plan.overlap_fallbacks or not four["halo_blocks"]:
        raise AssertionError("examples/euler2d_torch.py --devices 4: no "
                             "halo blocks, or an overlap fallback")
    out["euler"] = {k: {"first_s": r["first_s"], "step_ms": r["step_ms"]}
                    for k, r in (("1", one), ("4", four))}
    log(f"examples/euler2d_torch.py {EULER_NX} x {EULER_NY}, "
        f"{EULER_STEPS} steps: --devices 4 --px 2 --overlap within "
        f"max |diff| {err:.3e} of one shard, smax and rho range equal at "
        f"every printed step ({four['halo_blocks']} halo blocks); ms per "
        f"step one shard {one['step_ms']:.3f}, four {four['step_ms']:.3f}; "
        f"first step {one['first_s']:.3f} s, {four['first_s']:.3f} s "
        f"({card})")
    del one, four
    clear_executable_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grad_rel_diffs(a: dict, b: dict) -> dict:
    """Per parameter ||a - b|| / ||b||, in float32 (0 where both are 0)."""
    out = {}
    for name, want in b.items():
        w = want.float()
        num = float((a[name].float() - w).norm())
        den = float(w.norm())
        out[name] = num / den if den else (0.0 if num == 0 else float("inf"))
    return out


def grad_gate(arch: str, params, batch, cfg, detach, card: str,
              replay_routes: bool = False) -> dict:
    """Phase 3f(b): the kernel route's gradients of one batch against the
    plain route's (``use_kernel=False``), parameter by parameter, within
    ``GRAD_REL_TOL[arch]`` relative L2, over the parameters
    ``GRAD_GATE_EXCLUDES`` leaves in; the projections that feed the
    kernel (``GRAD_NEEDED``, fnmatch patterns) must get a non-zero
    gradient; and the same gradients with the kernel's output detached
    (``detach``: a context that patches the model to drop the kernel's
    gradient, what the route did before its ``autograd.Function``) must
    fall outside the limit.  Where ``detach`` yields the calls it took
    (``k6_detached``) they must be every K6 call of the forward and its
    remat recompute (an encoder's layers are not recomputed then), and
    every ``GRAD_NEEDED`` projection's gradient 0 under it.  For a K6
    arch the plain route at half its chunks is printed against the plain
    route: the limit's floor, the bf16 route's own rounding.  With
    ``replay_routes`` (a routed arch) the plain route and the detached
    variant replay the kernel route's expert choices, call by call (the
    remat recompute's too)."""
    import torch

    from repro_torch.models.lm import forward_loss

    def loss_and_grads(params, batch, cfg, use_kernel=True, replay=None):
        # a gradient the route never reaches reads 0 (the detached variant
        # leaves the projections into the kernel out of the graph, where
        # the train step's autograd.grad would raise)
        names, leaves = zip(*[(n, t) for n, t in params.named_parameters()
                              if gated(arch, n)])
        with expert_choices(replay=replay) as chosen:
            loss = forward_loss(params, batch, cfg,
                                use_kernel=use_kernel)[0]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), dict(zip(names, grads)), chosen

    def needed(pattern=None):
        pats = GRAD_NEEDED[arch] if pattern is None else (pattern,)
        return lambda n: any(fnmatch.fnmatchcase(n, p) for p in pats)

    lim = GRAD_REL_TOL[arch]
    t0 = time.perf_counter()
    loss_k, kern, routes = loss_and_grads(params, batch, cfg)
    routes = routes if replay_routes else None
    loss_p, plain, _ = loss_and_grads(params, batch, cfg, use_kernel=False,
                                      replay=routes)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rel = grad_rel_diffs(kern, plain)
    worst = max(rel, key=rel.get)
    zero = [n for n in kern if needed()(n)
            and float(kern[n].float().norm()) == 0.0]
    log(f"grad gate {arch} ({cfg.param_dtype}, {cfg.n_layers} layers, "
        f"batch {tuple(batch['tokens'].shape)}): loss kernel route "
        f"{float(loss_k):.6f}, plain "
        f"{float(loss_p):.6f}; {len(rel)} parameters"
        f"{' (without ' + ', '.join(GRAD_GATE_EXCLUDES[arch]) + ')' if arch in GRAD_GATE_EXCLUDES else ''}"
        f", max relative L2 difference {rel[worst]:.3e} ({worst}; limit "
        f"{lim:g}); median {statistics.median(rel.values()):.3e}; both "
        f"routes {secs:.2f} s ({card})")
    for part in sorted(GRAD_NEEDED[arch]):
        vals = [v for n, v in rel.items() if needed(part)(n)]
        log(f"grad gate {arch} {part}: relative L2 difference max "
            f"{max(vals):.3e} over {len(vals)} tensors")
    if zero:
        raise AssertionError(f"{arch}: zero gradient through the kernel for "
                             f"{zero}")
    if rel[worst] > lim:
        raise AssertionError(f"{arch}: {worst} gradient {rel[worst]:.3e} "
                             f"from the plain route's, limit {lim:g}")
    del kern
    if detach is k6_detached:
        # the limit's floor: the plain route against itself at half its
        # chunks, which moves its float32 sums as K6's do and rounds the
        # attention output to bf16 once as K6 does
        half = cfg.with_(q_chunk=cfg.q_chunk // 2, k_chunk=cfg.k_chunk // 2)
        _, ctrl, _ = loss_and_grads(params, batch, half, use_kernel=False,
                                    replay=routes)
        rel_ctrl = grad_rel_diffs(ctrl, plain)
        w = max(rel_ctrl, key=rel_ctrl.get)
        log(f"grad gate {arch} control (the plain route at chunks "
            f"{half.q_chunk} against {cfg.q_chunk}): max relative L2 "
            f"{rel_ctrl[w]:.3e} ({w}), median "
            f"{statistics.median(rel_ctrl.values()):.3e}")
        del ctrl
    with detach() as calls:
        _, cut, _ = loss_and_grads(params, batch, cfg, replay=routes)
    rel_cut = grad_rel_diffs(cut, plain)
    bad = sorted(n for n, v in rel_cut.items() if v > lim)
    log(f"grad gate {arch} wrong variant (the kernel's output detached): "
        f"{len(bad)} parameters outside the limit, max "
        f"{max(rel_cut.values()):.3e} ({bad[:3]}...)")
    if not bad:
        raise AssertionError(f"{arch}: the gradient limit does not see the "
                             f"kernel's output detached")
    if calls is not None:
        leaked = [n for n in cut if needed()(n)
                  and float(cut[n].float().norm()) != 0.0]
        # the forward's calls and the remat recompute's, but for an
        # encoder's: with every K6 output detached its output reaches the
        # loss only through the (detached) cross-attention, so the
        # backward never unpacks its layers' checkpoints
        want = k6_calls(cfg)[1] - (cfg.enc_layers if cfg.remat == "full"
                                   else 0)
        log(f"grad gate {arch} wrong variant: {len(calls)} K6 calls "
            f"detached (expected {want}), {len(leaked)} GRAD_NEEDED "
            f"projections with a gradient under it")
        if len(calls) != want or leaked:
            raise AssertionError(f"{arch}: the detached variant took "
                                 f"{len(calls)} K6 calls, left gradients "
                                 f"in {leaked[:5]}")
    return {"max_rel": rel[worst], "worst": worst,
            "detached_max": max(rel_cut.values())}


def log_top_kernels(what: str, by_kernel: dict, wall_ms: float,
                    card: str, n: int = 6) -> float:
    """Log the device time of ``by_kernel`` (name -> (us, launches)) against
    ``wall_ms`` and its ``n`` largest kernels; returns the device ms."""
    busy = sum(us for us, _ in by_kernel.values()) / 1e3
    log(f"{what}: device {busy:.2f} ms of {wall_ms:.1f} ms a step "
        f"({100 * busy / wall_ms:.1f} % busy; the profiled step's trace) "
        f"({card})")
    for name, (us, count) in sorted(by_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:n]:
        log(f"  {us / 1e3:.3f} ms, {count} launches: {name[:90]}")
    return busy


class TimedCheckpoints:
    """A ``CheckpointManager`` that records each save: the step, the
    milliseconds ``save`` held the caller (the host snapshot, and the wait
    for a write still in flight) and the bytes of the snapshot."""

    def __init__(self, directory: str):
        from repro_torch.checkpoint import CheckpointManager

        self.mgr = CheckpointManager(directory)
        self.saves = []

    def save(self, step, tree, extra=None, blocking=False):
        from repro_torch.checkpoint import named_leaves

        t0 = time.perf_counter()
        self.mgr.save(step, tree, extra, blocking=blocking)
        nbytes = sum(t.nbytes for _, t, _ in named_leaves(tree))
        self.saves.append((step, (time.perf_counter() - t0) * 1e3, nbytes))

    def __getattr__(self, name):
        return getattr(self.mgr, name)


def train_moe(card: str, zero_counts, counts_now, on_card,
              k6_detached) -> dict:
    """Phase 3f(a2): phi3.5-moe at its published width cut to
    ``TRAIN_MOE_LAYERS`` layers (bf16, AdamW, ``remat="full"``,
    microbatches 2), ``TRAIN_MOE_STEPS`` steps on one repeated
    ``SyntheticLM`` batch of ``TRAIN_MOE_BATCH`` x ``TRAIN_SEQ`` under
    ``torch.use_deterministic_algorithms(True)``, through
    ``make_train_step`` once with the local dispatch and once with
    ``mesh=`` a ``PAR_MESH`` mesh of the card (``moe_a2a``): each run's
    loss finite and falling, K6 twice a layer a microbatch a step, ms a
    step; then the gradient gate on the local dispatch's model, the
    plain route replaying the kernel route's expert choices."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import init_lm, param_count
    from repro_torch.optim import cosine_schedule

    dev = torch.device("cuda")
    full = configs.get("phi3.5-moe")
    cfg = full.with_(n_layers=TRAIN_MOE_LAYERS)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_MOE_BATCH, seed=0)
    batch = on_card(data.batch_at(0))
    mesh = make_mesh(PAR_MESH, ("data", "model"),
                     devices=["cuda:0"] * (PAR_MESH[0] * PAR_MESH[1]))
    log(f"train phi3.5-moe: published width (d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}), depth "
        f"cut {full.n_layers} -> {cfg.n_layers} layers: "
        f"{param_count(cfg)} parameters; {cfg.param_dtype}, "
        f"{cfg.optimizer}, remat={cfg.remat}, microbatches "
        f"{cfg.microbatches}, batch {TRAIN_MOE_BATCH} x {TRAIN_SEQ}, "
        f"deterministic algorithms")
    out = {"k6": 0}
    # K6 in each microbatch's forward, and again in its remat recompute
    expect = ((2 if cfg.remat == "full" else 1) * TRAIN_MOE_LAYERS
              * cfg.microbatches * TRAIN_MOE_STEPS)
    torch.use_deterministic_algorithms(True)
    try:
        for mode, m in (("local dispatch", None),
                        (f"moe_a2a on {PAR_MESH}", mesh)):
            step_fn, opt = make_train_step(
                cfg, lr=cosine_schedule(3e-4, min(100, TRAIN_MOE_STEPS // 10),
                                        TRAIN_MOE_STEPS),
                device=dev, mesh=m)
            params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
            params.requires_grad_(True)
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)}
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            losses, times = [], []
            for _ in range(TRAIN_MOE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step_fn(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(met["loss"]))
            counts = counts_now()
            step_s = statistics.median(times[1:])
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"train phi3.5-moe ({mode}): losses "
                f"{[round(x, 4) for x in losses]}; {step_s * 1e3:.1f} ms a "
                f"step (median of steps 2-{TRAIN_MOE_STEPS}; the first "
                f"{times[0] * 1e3:.1f}), "
                f"{TRAIN_MOE_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, peak "
                f"{peak:.2f} GiB; K6 launches {counts['flash_attention']} "
                f"({card})")
            if counts["flash_attention"] != expect:
                raise AssertionError(f"train phi3.5-moe ({mode}): launches "
                                     f"{counts}, expected flash_attention "
                                     f"{expect}")
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"train phi3.5-moe ({mode}): losses "
                                     f"{losses} not finite and falling")
            out["k6"] += counts["flash_attention"]
            out[mode] = dict(losses=losses, step_ms=step_s * 1e3,
                             first_ms=times[0] * 1e3, peak_gib=peak)
            if m is None:
                out["gate"] = grad_gate(
                    "phi3.5-moe", params, {k: v[:1] for k, v in
                                           batch.items()},
                    cfg, k6_detached, card, replay_routes=True)
            del step_fn, opt, params, state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def k6_calls(cfg) -> tuple[int, int]:
    """K6 calls in one forward of ``cfg``'s model (its attention layers,
    an encoder-decoder's cross-attentions and encoder layers) and in one
    microbatch of a train step, where ``remat="full"`` recomputes the
    layer groups and the encoder's layers in the backward."""
    n_groups, pattern, tail = cfg.layer_groups()

    def attn(kinds):
        return sum(k in ("A", "L") for k in kinds) * (2 if cfg.is_encdec
                                                      else 1)

    grouped = n_groups * attn(pattern) + cfg.enc_layers
    fwd = grouped + attn(tail)
    return fwd, fwd + (grouped if cfg.remat == "full" else 0)


def layer_kinds(cfg) -> set:
    """The layer kinds of ``cfg``'s depth (its pattern cycled)."""
    return {cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)}


def train_attention_shapes(cfg, seq: int) -> dict:
    """The attention calls of training ``cfg`` on rows of ``seq`` tokens
    (with ``launch/train.make_batch_at``'s ``seq`` frames or
    ``frontend_tokens`` patch positions), by label: ``(Sq, Skv, Hq, Hkv,
    D, causal, window)``."""
    H, Hkv, D = cfg.padded_heads(), cfg.padded_kv_heads(), cfg.head_dim
    if cfg.is_encdec:
        return {"encoder": (seq, seq, H, Hkv, D, False, None),
                "decoder self": (seq, seq, H, Hkv, D, True, None),
                "cross": (seq, seq, H, Hkv, D, False, None)}
    S = seq + (cfg.frontend_tokens if cfg.frontend_dim else 0)
    kinds = layer_kinds(cfg)
    return {k: (S, S, H, Hkv, D, True, cfg.window if k == "L" else None)
            for k in ("L", "A") if k in kinds}


def gated(arch: str, name: str) -> bool:
    """Whether the gradient gate compares parameter ``name`` of ``arch``
    (``GRAD_GATE_EXCLUDES``)."""
    return not any(fnmatch.fnmatchcase(name, pat)
                   for pat in GRAD_GATE_EXCLUDES.get(arch, ()))


def train_reckoning(arch: str, cfg, rows: int, seq: int) -> dict:
    """Bytes of training ``cfg`` on ``rows`` x ``seq`` tokens, reckoned from
    shapes (a model on the meta device, the optimizer's state made there):
    the weights; their gradients (the parameter dtype, or float32 sums
    and one microbatch's); the optimizer's state; the logits and their
    gradient (16 bytes a logit: the bf16 logits, ``ce_loss``'s float32
    copy, its exponentials, the float32 gradient and its bf16 cast); the
    plain recompute of the largest attention call in K6's backward (the
    float32 scores and probabilities it saves, 8 bytes a score of every
    chunk pair the chunked version visits, and three float32 gradients
    of one pair's); the gate's three gradient sets of its compared
    leaves at one row.
    ``step`` is weights + state + gradients + the larger transient;
    ``gate`` weights + three gradient sets + the transient of one row
    (the state is freed before the gate); ``peak`` the larger."""
    from repro_torch.models.common import Init
    from repro_torch.models.lm import _build_lm
    from repro_torch.optim import make_optimizer

    model = _build_lm(cfg, Init(None, cfg.param_torch_dtype, "meta"))
    named = dict(model.named_parameters())
    n = sum(p.numel() for p in named.values())
    pb = cfg.param_torch_dtype.itemsize
    state = make_optimizer(cfg.optimizer, 1.0).init(model)
    moments = 4 * sum(t.numel() for leaf in state.values()
                      for t in leaf.values())
    S_out = seq + (cfg.frontend_tokens if cfg.frontend_dim
                   and not cfg.is_encdec else 0)
    logits = 16 * rows * S_out * cfg.padded_vocab()
    attn = max(rows * hq * (8 * sq * skv + 12 * min(sq, cfg.q_chunk)
                            * min(skv, cfg.k_chunk))
               for sq, skv, hq, *_ in
               train_attention_shapes(cfg, seq).values())
    n_gated = sum(p.numel() for k, p in named.items() if gated(arch, k))
    r = dict(params=n, weights=n * pb, moments=moments,
             grads=n * (pb if cfg.microbatches == 1 else 4 + pb),
             logits=logits, attention=attn, gated=n_gated)
    transient = max(logits, attn)
    r["step"] = r["weights"] + moments + r["grads"] + transient
    r["gate"] = r["weights"] + 3 * n_gated * pb + transient // rows
    r["peak"] = max(r["step"], r["gate"])
    return r


def train_config(arch: str):
    """The published config of ``arch`` cut as ``TRAIN_ARCH_CASES`` says."""
    from repro_torch import configs

    return configs.get(arch).with_(**TRAIN_ARCH_CASES[arch][0])


@contextlib.contextmanager
def k6_detached():
    """K6's output detached from the graph (what the model's route did
    before ``FlashAttentionFn``): ``models.attention.flash_attention_fn``
    patched to run under ``torch.no_grad``, which every attention call of
    the model (decoder, encoder, cross-attention) goes through.  Yields
    the list of the calls it took."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_fn
    from repro_torch.models import attention as model_attention

    calls = []

    def cut(*args, **kw):
        calls.append(1)
        with torch.no_grad():
            return flash_attention_fn(*args, **kw)

    model_attention.flash_attention_fn = cut
    try:
        yield calls
    finally:
        model_attention.flash_attention_fn = flash_attention_fn


def train_case(arch: str, cfg, rows: int, steps: int, card: str,
               zero_counts, counts_now) -> tuple[dict, dict, dict]:
    """Phase 3f's training of one case: ``cfg`` through
    ``launch/train.build_trainer`` for ``steps`` steps on one repeated
    batch of ``rows`` x ``TRAIN_SEQ`` (``SyntheticLM`` seed 0, with
    ``make_batch_at``'s frames or patches), then one step under
    ``torch.profiler`` (its CUDA activity: the CPU side's trace of
    seamless's ~20k launches and their ops took 58 s on the H100's host).
    Fatal: the loss finite and falling, and K6's launches
    ``k6_calls(cfg)`` a microbatch a step, no other kernel.  Logged: ms
    a step, tokens/s, peak memory, 6 N tokens over the step time at 989
    TFLOP/s, the profiled step's device time, K6's kernels in it and its
    largest kernels (``k6_backward_share`` sets K6's backward beside
    them).  Returns (readings, the train state, the batch)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import build_trainer, make_batch_at
    from repro_torch.models.lm import param_count

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    step_fn, state = build_trainer(cfg, total_steps=steps, device=dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=rows, seed=0)
    batch = make_batch_at(cfg, data, batch=rows, seq=TRAIN_SEQ,
                          device=dev)(0)
    zero_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # one more step under the profiler: K6's kernels and the device time
    # of the whole step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
    counts = counts_now()
    cuda = torch.autograd.DeviceType.CUDA
    ev = prof.key_averages()
    k6_us = sum(e.self_device_time_total for e in ev
                if e.device_type == cuda and "attn_" in e.key)
    step_us = sum(e.self_device_time_total for e in ev
                  if e.device_type == cuda)
    expect = k6_calls(cfg)[1] * cfg.microbatches * (steps + 1)
    others = {k: n for k, n in counts.items()
              if k != "flash_attention" and n}
    if counts["flash_attention"] != expect or others:
        raise AssertionError(f"train {arch}: launches {counts}, expected "
                             f"flash_attention {expect} and no other")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch}: losses {losses} not finite "
                             f"and falling")
    step_s = statistics.median(times[1:])
    tokens = rows * TRAIN_SEQ
    # the positions the model runs over: a VLM's patches too
    positions = rows * (TRAIN_SEQ + (cfg.frontend_tokens if cfg.frontend_dim
                                     and not cfg.is_encdec else 0))
    n_params = param_count(cfg)
    # a routed arch computes with top_k of its experts a token
    n_active = n_params
    if cfg.n_experts:
        n_expert = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * cfg.n_layers
        n_active -= n_expert * (1 - cfg.top_k / cfg.n_experts)
    mfu = 6 * n_active * positions / (step_s * BF16_TC_OPS_PER_S)
    out = dict(losses=losses, step_ms=step_s * 1e3, first_ms=times[0] * 1e3,
               tok_s=tokens / step_s, peak_gib=peak_gib, mfu=mfu,
               k6_us=k6_us, step_us=step_us,
               k6=counts["flash_attention"], params=n_params,
               active=n_active)
    log(f"train {arch}: losses {[round(x, 4) for x in losses]} (falling "
        f"{'every step' if all(a > b for a, b in zip(losses, losses[1:])) else 'overall'}); "
        f"{step_s * 1e3:.1f} ms a step (median of steps 2-{steps}; the "
        f"first {times[0] * 1e3:.1f}), {tokens / step_s:.0f} tokens/s, peak "
        f"{peak_gib:.2f} GiB allocated, 6 N tokens / (step x 989 TFLOP/s) "
        f"= {100 * mfu:.1f} % (N {n_active:.4g}"
        f"{' active of ' + format(n_params, '.4g') if cfg.n_experts else ''}"
        f", {positions} positions); K6 launches {counts['flash_attention']}"
        f" ({card})")
    log_top_kernels(f"train {arch} profiled step", {
        e.key: (e.self_device_time_total, e.count) for e in ev
        if e.device_type == cuda and e.self_device_time_total > 0},
        step_s * 1e3, card)
    log(f"train {arch} profiled step: device {step_us / 1e3:.2f} ms; K6 "
        f"kernels {k6_us / 1e3:.3f} ms over "
        f"{k6_calls(cfg)[1] * cfg.microbatches} launches ({card})")
    return out, state, batch


def train_attention_calls(cfg) -> dict:
    """The attention calls of one forward of ``cfg``'s model, by the
    labels of ``train_attention_shapes``."""
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    if cfg.is_encdec:
        n = sum(k in ("A", "L") for k in kinds)
        return {"encoder": cfg.enc_layers, "decoder self": n, "cross": n}
    return {k: kinds.count(k) for k in ("L", "A") if k in kinds}


def k6_backward_share(arch: str, cfg, r: dict, card: str) -> float:
    """K6's backward (``FlashAttentionFnBackward``: the plain version
    recomputed and differentiated) in a train step of ``cfg``: the
    device time of one call profiled alone at each attention shape
    (``k6_train_times``' ``bwd_dev_ms``) times the calls a step makes,
    against the profiled step's device time in ``r``; set as
    ``r["bwd_step_ms"]`` and returned."""
    calls = train_attention_calls(cfg)
    ms = cfg.microbatches * sum(n * r["k6_alone"][label]["bwd_dev_ms"]
                                for label, n in calls.items())
    r["bwd_step_ms"] = ms
    log(f"train {arch}: K6's forward {r['k6_us'] / 1e3:.3f} ms in the "
        f"profiled step, its backward {ms:.3f} ms a step ("
        + ", ".join(f"{n} x {label} "
                    f"{r['k6_alone'][label]['bwd_dev_ms']:.3f}"
                    for label, n in calls.items())
        + f" ms device, each call profiled alone) = "
        f"{100 * ms / (r['step_us'] / 1e3):.1f} % of the step's "
        f"{r['step_us'] / 1e3:.2f} device ms ({card})")
    return ms


def k6_train_times(arch: str, cfg, rows: int, card: str) -> dict:
    """K6 alone at each attention shape of training ``cfg`` on ``rows`` x
    ``TRAIN_SEQ`` (bf16): its forward (the kernel) against its backward
    (``FlashAttentionFn``'s: the plain version recomputed and
    differentiated; CUDA events around back-to-back calls, which the
    host's launch rate can set, and the device time of its kernels from
    one profiled call), and the plain forward alone.  Shapes that two
    calls share are timed once."""
    import torch

    from repro_torch.kernels.attention.kernel import flash_attention_fn
    from repro_torch.models.attention import attention

    dev = torch.device("cuda")
    out, done = {}, {}
    for label, shape in train_attention_shapes(cfg, TRAIN_SEQ).items():
        if shape in done:
            out[label] = done[shape]
            continue
        Sq, Skv, H, Hkv, D, causal, window = shape
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn(rows, S, h, D, generator=g, device=dev)
                   .bfloat16().requires_grad_()
                   for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
        qpos = torch.arange(Sq, device=dev)
        kpos = torch.arange(Skv, device=dev)

        def plain(q, k, v):
            return attention(q, k, v, qpos=qpos, kpos=kpos, causal=causal,
                             window=window, impl=cfg.attn_impl,
                             q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
                             use_kernel=False)

        def kernel():
            return flash_attention_fn(q, k, v, plain=plain, causal=causal,
                                      window=window)

        fwd_ms = time_ms(kernel, iters=10)
        o = kernel()
        grad_out = torch.randn(o.shape, generator=g, device=dev).bfloat16()
        def backward():
            return torch.autograd.grad(o, (q, k, v), grad_out,
                                       retain_graph=True)

        bwd_ms = time_ms(backward, iters=3, reps=3, warmup=1)
        bwd_dev_ms = sum(us for us, _ in device_time_by_kernel(
            backward, warmup=1).values()) / 1e3
        plain_ms = time_ms(lambda: plain(q.detach(), k.detach(),
                                         v.detach()), iters=3, reps=3,
                           warmup=1)
        done[shape] = out[label] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                                        bwd_dev_ms=bwd_dev_ms,
                                        plain_fwd_ms=plain_ms)
        mask = ("causal" if causal else "no mask") + (
            f", window {window}" if window else "")
        log(f"train {arch} K6 {label} at ({rows}, {Sq}"
            f"{'' if Sq == Skv else f' -> {Skv}'}, {H}/{Hkv} heads, {D}, "
            f"{mask}) bf16: forward (kernel) {fwd_ms:.4f} ms, backward "
            f"(plain {cfg.attn_impl} recompute) {bwd_ms:.4f} ms = "
            f"{bwd_ms / fwd_ms:.1f}x (its kernels' device time "
            f"{bwd_dev_ms:.4f} ms); the plain forward alone "
            f"{plain_ms:.4f} ms ({card})")
        del q, k, v, o, grad_out
    return out


def scan_launches(cfg, rows: int, card: str) -> dict:
    """The RG-LRU's doubling scan (``models/ssm.linear_scan``) alone at
    training ``cfg``'s width on ``rows`` x ``TRAIN_SEQ``, float32 as the
    layer runs it: the kernels its forward and its backward launch and
    their device ms (``device_time_by_kernel`` after one warm-up call
    under the profiler, which loses a short trace's first records)."""
    import torch

    from repro_torch.models.ssm import linear_scan

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    shape = (rows, TRAIN_SEQ, cfg.lru_width)
    a = torch.rand(shape, generator=g, device=dev).requires_grad_()
    b = torch.randn(shape, generator=g, device=dev).requires_grad_()
    grad_h = torch.randn(shape, generator=g, device=dev)
    h = linear_scan(a, b, dim=1)
    out = {}
    for part, fn in (("forward", lambda: linear_scan(a, b, dim=1)),
                     ("backward", lambda: torch.autograd.grad(
                         h, (a, b), grad_h, retain_graph=True))):
        ev = device_time_by_kernel(fn, warmup=1)
        out[part] = dict(launches=sum(n for _, n in ev.values()),
                         ms=sum(us for us, _ in ev.values()) / 1e3)
    log(f"RG-LRU scan alone at {shape} float32: forward "
        f"{out['forward']['launches']} launches, "
        f"{out['forward']['ms']:.3f} ms device; backward "
        f"{out['backward']['launches']} launches, "
        f"{out['backward']['ms']:.3f} ms ({card})")
    return out


def train_archs(card: str, zero_counts, counts_now) -> dict:
    """Phase 3f(f): each case of ``TRAIN_ARCH_CASES`` at every published
    width, cut in depth, through ``train_case`` (``TRAIN_ARCH_STEPS``
    steps of its rows x ``TRAIN_SEQ``, after its byte
    reckoning is logged and held under ``CARD_BYTES``), then its
    gradient gate on one row and K6 alone at its training shapes
    (recurrentgemma-9b also the RG-LRU scan's launches).  Returns the
    readings by arch and the K6 launches of the training runs."""
    import torch

    from repro_torch import configs

    out = {"k6": 0}
    for arch in TRAIN_ARCH_CASES:
        t_case = time.perf_counter()
        full = configs.get(arch)
        cfg, rows = train_config(arch), TRAIN_ARCH_CASES[arch][1]
        rk = train_reckoning(arch, cfg, rows, TRAIN_SEQ)
        log(f"train {arch}: published width (d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}"
            f"{f', window {cfg.window}' if cfg.window else ''}"
            f"{f', lru_width {cfg.lru_width}' if cfg.lru_width else ''}"
            f"{f', {cfg.n_experts} experts top-{cfg.top_k}' if cfg.n_experts else ''}"
            f"), depth {full.n_layers} -> {cfg.n_layers}"
            f"{f' (+ {cfg.enc_layers} encoder)' if cfg.enc_layers else ''}"
            f" layers, kinds {''.join(sorted(layer_kinds(cfg)))}: "
            f"{rk['params']} parameters; {cfg.param_dtype}, "
            f"{cfg.optimizer}, remat={cfg.remat}, microbatches "
            f"{cfg.microbatches}, batch {rows} x {TRAIN_SEQ}; "
            f"reckoned GB: weights {rk['weights'] / 1e9:.2f}, gradients "
            f"{rk['grads'] / 1e9:.2f}, optimizer {rk['moments'] / 1e9:.2f}, "
            f"logits {rk['logits'] / 1e9:.2f}, attention recompute "
            f"{rk['attention'] / 1e9:.2f}; step {rk['step'] / 1e9:.2f}, "
            f"gate {rk['gate'] / 1e9:.2f} of {CARD_BYTES / 1e9:.0f}; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held before "
            f"it")
        if rk["peak"] > CARD_BYTES:
            raise AssertionError(f"train {arch}: reckoned {rk['peak']} "
                                 f"bytes, over the card's {CARD_BYTES}")
        r, state, batch = train_case(arch, cfg, rows,
                                     TRAIN_ARCH_STEPS, card, zero_counts,
                                     counts_now)
        out["k6"] += r["k6"]
        r["reckoned"] = rk
        # the gate needs no optimizer state: free it first
        del state["opt"]
        gc.collect()
        torch.cuda.empty_cache()
        r["gate"] = grad_gate(arch, state["params"],
                              {k: v[:1] for k, v in batch.items()}, cfg,
                              k6_detached, card,
                              replay_routes=bool(cfg.n_experts))
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
        r["k6_alone"] = k6_train_times(arch, cfg, rows, card)
        k6_backward_share(arch, cfg, r, card)
        if cfg.lru_width:
            r["scan"] = scan_launches(cfg, rows, card)
        r["secs"] = time.perf_counter() - t_case
        log(f"train {arch}: the case took {r['secs']:.1f} s")
        out[arch] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def layer_grads_card_cpu(card: str) -> dict:
    """Phase 3f(g): the backward of the layers that have no kernel, on the
    card against the CPU, in float32 with TF32 off.  Per case of
    ``LAYER_GRAD_CASES`` at its published width (a recurrentgemma-9b "R"
    layer: the RG-LRU's conv, gates and doubling scan; a gemma3-12b "L"
    layer: sandwich norms, qk-norm, the local RoPE base, GEGLU; a
    seamless-m4t-medium encoder layer through ``encode``: the frontend
    projection, LayerNorm, QKV bias), the same seeded weights on both
    devices and one row of ``LAYER_GRAD_SEQ`` inputs: the gradients of
    ``sum(out * r)`` per parameter within ``LAYER_GRAD_TOL`` relative L2
    of the CPU's, none of them zero.  The CPU side is what tier-1 holds
    against ``jax.grad``."""
    import copy

    import numpy as np
    import torch
    from torch import nn

    from repro_torch import configs
    from repro_torch.models.blocks import init_layer, init_norm, \
        layer_forward
    from repro_torch.models.common import Init, ParamModule
    from repro_torch.models.lm import encode

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for arch, kind in LAYER_GRAD_CASES:
            enc = kind == "encoder"
            cfg = configs.get(arch).with_(
                param_dtype="float32", compute_dtype="float32",
                remat="none", **({"enc_layers": 1} if enc else {}))
            # made on the card (the CPU's generator is far slower at
            # these sizes) and copied to each device
            init = Init(torch.Generator(device="cuda").manual_seed(0),
                        torch.float32, "cuda")
            p = ParamModule()
            if enc:
                init.dense(p, "frontend_proj", (cfg.frontend_dim,
                                                cfg.d_model),
                           fan_in=cfg.frontend_dim)
                layer = ParamModule()
                init_layer(init, layer, cfg, "A", name="p0")
                p.add_module("encoder", nn.ModuleList([layer]))
                fin = ParamModule()
                init_norm(init, fin, cfg, "ln", cfg.d_model)
                p.add_module("enc_final", fin)
            else:
                init_layer(init, p, cfg, kind, name="layer")
            rng = np.random.default_rng(0)
            x = rng.standard_normal((1, LAYER_GRAD_SEQ, cfg.frontend_dim
                                     if enc else cfg.d_model))
            r = rng.standard_normal((1, LAYER_GRAD_SEQ, cfg.d_model))

            def grads(dev):
                q = copy.deepcopy(p).to(dev)
                q.requires_grad_(True)
                h = torch.from_numpy(x.astype(np.float32)).to(dev)
                y = (encode(q, h, cfg) if enc else
                     layer_forward(q["layer"], h, kind, cfg)[0])
                loss = (y * torch.from_numpy(r.astype(np.float32))
                        .to(dev)).sum()
                names, leaves = zip(*q.named_parameters())
                return dict(zip(names, (t.cpu() for t in torch.autograd.grad(
                    loss, leaves))))

            t0 = time.perf_counter()
            want = grads("cpu")
            cpu_s = time.perf_counter() - t0
            got = grads("cuda")
            rel = grad_rel_diffs(got, want)
            worst = max(rel, key=rel.get)
            zero = [n for n, t in want.items() if float(t.norm()) == 0.0]
            log(f"layer gradients {arch} {kind} (published width, float32, "
                f"TF32 off, 1 x {LAYER_GRAD_SEQ}): {len(rel)} parameters, "
                f"card against CPU max relative L2 {rel[worst]:.3e} "
                f"({worst}; limit {LAYER_GRAD_TOL:g}), median "
                f"{statistics.median(rel.values()):.3e}; the CPU side "
                f"{cpu_s:.1f} s ({card})")
            if zero:
                raise AssertionError(f"layer gradients {arch} {kind}: zero "
                                     f"gradients {zero}")
            if rel[worst] > LAYER_GRAD_TOL:
                raise AssertionError(f"layer gradients {arch} {kind}: "
                                     f"{worst} {rel[worst]:.3e} from the "
                                     f"CPU's, limit {LAYER_GRAD_TOL:g}")
            out[f"{arch} {kind}"] = dict(max_rel=rel[worst], worst=worst,
                                         cpu_s=cpu_s)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def train_phase(card: str, zero_counts, counts_now) -> dict:
    """Phase 3f: the training path on the card.  (a) qwen3-8b at its
    published width cut to ``TRAIN_QWEN_LAYERS`` layers, bf16, AdamW,
    ``remat="full"``: ``TRAIN_QWEN_STEPS`` steps on one repeated
    ``SyntheticLM`` batch (seed 0) of ``TRAIN_QWEN_BATCH`` x ``TRAIN_SEQ``
    through ``launch/train.build_trainer``'s step, the loss finite and
    falling; ms a step, tokens/s, peak memory, model FLOP utilisation;
    K6 twice a layer a step (the forward and the remat recompute), and
    the device time of K6 in one profiled step against its
    plain-recompute backward's (``k6_backward_share``), both also timed
    alone at the training shape.  (b) the gradient
    gate (``grad_gate``) on one batch of (a)'s model and of mamba2-130m
    at its published config in float32 (see ``GRAD_REL_TOL``).
    (c) mamba2-130m at its published config, batch ``TRAIN_MAMBA_BATCH`` x
    ``TRAIN_SEQ``, through ``build_trainer`` and the ``Supervisor`` with a
    ``CheckpointManager`` in a temporary directory (deleted afterwards),
    a checkpoint every ``TRAIN_CKPT_EVERY`` steps, ``TRAIN_MAMBA_STEPS``
    steps, under ``torch.use_deterministic_algorithms(True)``: once
    without a fault and once with ``Fault("supervisor.step",
    step=TRAIN_FAULT_STEP)``, which restores the last checkpoint and
    replays; every step's loss, the final parameters, moments and step
    counter bit for bit the uninterrupted run's; K7 twice a layer a step;
    then a step of a fresh trainer alone and under the profiler.  The
    ``Prefetcher`` first brings the phase's batches to the card, each
    equal to its source's.  (d) ``examples/train_lm_torch.py --steps
    50``.  (e) the serve launcher's ``--smoke --chaos`` (both archs) and
    ``--smoke --legacy``, in this process.  (f) ``train_archs``: the
    other archs' training cases, and (g) ``layer_grads_card_cpu``.
    Returns the readings and the launches of (a), (c) and (f)'s training
    runs; (b) and (f)'s gates and alone timings compare the kernels with
    their plain versions and (d), (e) run reduced configs, so theirs do
    not count."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data import Prefetcher, SyntheticLM
    from repro_torch.checkpoint import named_leaves
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.kernel import SsdIntraChunkFn
    from repro_torch.launch import serve
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.lm import param_count
    from repro_torch.runtime import Fault, FaultPlan, Supervisor, fault_scope

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {"launches": {}}

    def on_card(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    # -- (a) qwen3-8b, full width, depth cut ------------------------------
    full = configs.get("qwen3-8b")
    cfg = full.with_(n_layers=TRAIN_QWEN_LAYERS)
    log(f"train qwen3-8b: published width (d_model {cfg.d_model}, {cfg.n_heads}"
        f" heads, {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), depth cut {full.n_layers} -> {cfg.n_layers} "
        f"layers: {param_count(cfg)} parameters (the full model's "
        f"{param_count(full)} need ~12 bytes each for bf16 weights and "
        f"gradients and float32 moments, over the card's 80 GB); "
        f"{cfg.param_dtype}, {cfg.optimizer}, remat={cfg.remat}, "
        f"attn_impl={cfg.attn_impl}, batch {TRAIN_QWEN_BATCH} x {TRAIN_SEQ}")
    out["qwen"], state, batch = train_case(
        "qwen3-8b", cfg, TRAIN_QWEN_BATCH, TRAIN_QWEN_STEPS, card,
        zero_counts, counts_now)
    out["launches"]["flash_attention"] = out["qwen"]["k6"]
    # K6 forward against its backward alone, at the training shape
    out["qwen"]["k6_alone"] = k6_train_times("qwen3-8b", cfg,
                                             TRAIN_QWEN_BATCH, card)
    k6_backward_share("qwen3-8b", cfg, out["qwen"], card)

    # -- (b) the gradient gate ----------------------------------------------
    zero_counts()
    out["gate"] = {"qwen3-8b": grad_gate(
        "qwen3-8b", state["params"], {k: v[:1] for k, v in batch.items()},
        cfg, k6_detached, card)}
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    class SsdDetached:
        @staticmethod
        def apply(*args):
            with torch.no_grad():
                return SsdIntraChunkFn.apply(*args)

    @contextlib.contextmanager
    def k7_detached():
        ssd_ops.SsdIntraChunkFn = SsdDetached
        try:
            yield
        finally:
            ssd_ops.SsdIntraChunkFn = SsdIntraChunkFn

    mcfg = configs.get("mamba2-130m")
    mdata = SyntheticLM(vocab_size=mcfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_MAMBA_BATCH, seed=0)
    gcfg = mcfg.with_(param_dtype="float32", compute_dtype="float32")
    _, mstate = build_trainer(gcfg, total_steps=TRAIN_MAMBA_STEPS,
                              device=dev)
    out["gate"]["mamba2-130m"] = grad_gate(
        "mamba2-130m", mstate["params"], on_card(mdata.batch_at(0)), gcfg,
        k7_detached, card)
    del mstate
    gc.collect()
    torch.cuda.empty_cache()

    # -- (a2) phi3.5-moe, full width, depth cut, deterministic: the local
    # dispatch and moe_a2a on a mesh of the card; its gradient gate -------
    out["moe"] = train_moe(card, zero_counts, counts_now, on_card,
                           k6_detached)
    out["gate"]["phi3.5-moe"] = out["moe"].pop("gate")
    out["launches"]["flash_attention"] += out["moe"].pop("k6")

    # -- (c) mamba2-130m through the Supervisor, a step fault, a restore --
    pf = Prefetcher(mdata, depth=2, device=dev)
    try:
        for want_step in range(TRAIN_MAMBA_STEPS):
            step, got = pf.next()
            want = mdata.batch_at(want_step)
            if step != want_step or any(
                    not torch.equal(got[key].cpu(),
                                    torch.from_numpy(want[key]))
                    for key in want):
                raise AssertionError(f"prefetcher: step {step} differs "
                                     f"from batch_at({want_step})")
    finally:
        pf.close()
    log(f"prefetcher: {TRAIN_MAMBA_STEPS} batches of {TRAIN_MAMBA_BATCH} x "
        f"{TRAIN_SEQ} on the card in order, each equal to batch_at(step)")

    def supervised(ckpt_dir, plan):
        step_fn, state = build_trainer(mcfg, total_steps=TRAIN_MAMBA_STEPS,
                                       device=dev)
        losses = {}

        def step_and_log(state, batch):
            state, m = step_fn(state, batch)
            losses[int(state["step"])] = float(m["loss"])
            return state

        ckpt = TimedCheckpoints(ckpt_dir)
        sup = Supervisor(step_fn=step_and_log, ckpt=ckpt,
                         ckpt_every=TRAIN_CKPT_EVERY, log=log)
        t0 = time.perf_counter()
        with fault_scope(plan):
            state = sup.run(state, lambda i: on_card(mdata.batch_at(i)), 0,
                            TRAIN_MAMBA_STEPS)
        torch.cuda.synchronize()
        return state, losses, sup, ckpt, time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    torch.use_deterministic_algorithms(True)
    try:
        zero_counts()
        want, want_losses, _, ckpt0, secs0 = supervised(
            os.path.join(tmp, "clean"), FaultPlan([]))
        plan = FaultPlan([Fault("supervisor.step", step=TRAIN_FAULT_STEP)])
        got, got_losses, sup, ckpt, secs = supervised(
            os.path.join(tmp, "faulted"), plan)
        counts = counts_now()
        t0 = time.perf_counter()
        ckpt.save(TRAIN_MAMBA_STEPS, got, blocking=True)
        write_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    # the clean run's steps, the faulted run's before its fault, and its
    # replay from the last checkpoint before the fault
    restored = TRAIN_FAULT_STEP // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    steps_run = (TRAIN_MAMBA_STEPS + TRAIN_FAULT_STEP
                 + TRAIN_MAMBA_STEPS - restored)
    expect = 2 * mcfg.n_layers * steps_run
    out["launches"]["ssd_intra_chunk"] = counts["ssd_intra_chunk"]
    if counts["ssd_intra_chunk"] != expect or counts["flash_attention"]:
        raise AssertionError(f"train mamba2-130m: launches {counts}, "
                             f"expected ssd_intra_chunk {expect}")
    if not plan.exhausted() or sup.failures != 1:
        raise AssertionError(f"train mamba2-130m: fault plan\n"
                             f"{plan.report()}\nfailures {sup.failures}")
    resumed = [(f, r) for f, r, _ in sup.recoveries]
    if resumed != [(TRAIN_FAULT_STEP, TRAIN_FAULT_STEP)]:
        raise AssertionError(f"train mamba2-130m: recoveries {resumed}")
    if got_losses != want_losses:
        raise AssertionError(f"train mamba2-130m: losses {got_losses} != "
                             f"{want_losses}")
    a = {n: t for n, t, _ in named_leaves(got)}
    b = {n: t for n, t, _ in named_leaves(want)}
    diff = [n for n in b if not torch.equal(a[n], b[n])]
    if a.keys() != b.keys() or diff:
        raise AssertionError(f"train mamba2-130m: state after the restore "
                             f"differs in {diff[:5]}")
    # a new batch of uniform random tokens every step: the loss stays
    # near ln(vocab) over these 8 steps, so only its being finite is held
    ml = [want_losses[i + 1] for i in range(TRAIN_MAMBA_STEPS)]
    if not all(np.isfinite(ml)):
        raise AssertionError(f"train mamba2-130m: losses {ml}")
    gb = ckpt.saves[0][2] / 1e9
    out["mamba"] = dict(losses=ml, saves=ckpt.saves, clean_saves=ckpt0.saves,
                        write_ms=write_ms, recovery_ms=sup.recoveries[0][2],
                        secs=secs, clean_secs=secs0,
                        step_ms=sup.stats.mean * 1e3, gb=gb)
    log(f"train mamba2-130m (published config, batch {TRAIN_MAMBA_BATCH} x "
        f"{TRAIN_SEQ}, deterministic algorithms): losses "
        f"{[round(x, 4) for x in ml]}; fault at step {TRAIN_FAULT_STEP} "
        f"restored step {restored} and replayed: every loss, parameter, moment and the step counter "
        f"bit for bit the uninterrupted run's; recovery "
        f"{sup.recoveries[0][2]:.1f} ms; runs {secs0:.2f} s clean, "
        f"{secs:.2f} s faulted; {sup.stats.mean * 1e3:.1f} ms a step "
        f"(mean, completion); K7 launches {counts['ssd_intra_chunk']} "
        f"({card})")
    log(f"train mamba2-130m checkpoints ({gb:.3f} GB each: bf16 parameters,"
        f" float32 moments): save() held the loop "
        f"{[round(ms, 1) for _, ms, _ in ckpt0.saves]} ms clean, "
        f"{[round(ms, 1) for _, ms, _ in ckpt.saves[:-1]]} ms faulted; one "
        f"blocking save (snapshot and write) {write_ms:.1f} ms = "
        f"{gb / write_ms * 1e3:.2f} GB/s ({card})")
    del want, got
    gc.collect()
    torch.cuda.empty_cache()
    # where a mamba2-130m step's time goes: three steps of a fresh trainer
    # with no checkpoint, then one under the profiler (its K7 launches are
    # not the supervised runs' and are not counted)
    step_fn, st = build_trainer(mcfg, total_steps=TRAIN_MAMBA_STEPS,
                                device=dev)
    batch = on_card(mdata.batch_at(0))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = step_fn(st, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(walls[1:])
    out["mamba"]["alone_ms"] = step_ms
    out["mamba"]["busy_ms"] = log_top_kernels(
        f"train mamba2-130m, a step without checkpoints {step_ms:.1f} ms "
        f"(median of steps 2-3; the first {walls[0]:.1f}); profiled step",
        device_time_by_kernel(lambda: step_fn(st, batch)), step_ms, card)
    del step_fn, st, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) the example, (e) the serve launcher's chaos and legacy modes --
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    try:
        t0 = time.perf_counter()
        ex_losses = load_example("train_lm_torch").main(
            ["--steps", "50", "--ckpt-dir", tmp])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"examples/train_lm_torch.py --steps 50 on the card: loss "
        f"{ex_losses[0]:.4f} -> {ex_losses[-1]:.4f} in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    out["example"] = (ex_losses[0], ex_losses[-1])
    for flags in (["--arch", "qwen3-8b", "--smoke", "--chaos"],
                  ["--arch", "mamba2-130m", "--smoke", "--chaos"],
                  ["--smoke", "--legacy"]):
        log(f"serve {' '.join(flags)} on the card:")
        serve.main(flags)

    # -- (f) the other archs' training, (g) the layers without a kernel --
    out["archs"] = train_archs(card, zero_counts, counts_now)
    out["launches"]["flash_attention"] += out["archs"].pop("k6")
    out["layers"] = layer_grads_card_cpu(card)
    out["secs"] = time.perf_counter() - t_phase
    log(f"phase 3f: {out['secs']:.1f} s ({card})")
    return out


@contextlib.contextmanager
def expert_choices(replay=None, order=None):
    """``models/moe.py``'s ``_top_k`` wrapped: yields the list of every
    call's choice, in call order; with ``replay``, call ``i`` returns
    ``replay[order(i)]`` (``order`` defaults to ``i``) in place of its
    own choice."""
    from repro_torch.models import moe

    real = moe._top_k
    chosen = []

    def route(probs, k):
        i = len(chosen)
        idx = real(probs, k) if replay is None \
            else replay[i if order is None else order(i)]
        chosen.append(idx)
        return idx

    moe._top_k = route
    try:
        yield chosen
    finally:
        moe._top_k = real


@contextlib.contextmanager
def dropped_pairs():
    """``models/moe.py``'s ``_dispatch_slots`` wrapped: yields the list
    of the (token, k) pairs each call drops (device scalars), in call
    order."""
    from repro_torch.models import moe

    real = moe._dispatch_slots
    dropped = []

    def counting(gate_idx, n_experts, C):
        slots = real(gate_idx, n_experts, C)
        dropped.append((~slots[1]).sum())
        return slots

    moe._dispatch_slots = counting
    try:
        yield dropped
    finally:
        moe._dispatch_slots = real


@contextlib.contextmanager
def reverse_exchange_reversed():
    """The wrong variant of the a2a: its reverse ``all_to_all`` takes the
    shards of each group in reversed order, so each data shard gets
    another shard's experts' outputs."""
    from repro_torch.core import collectives as coll

    real = coll.all_to_all

    def wrong(xs, mesh, axes, split_axis, concat_axis):
        if split_axis == 1:
            xs = list(xs)
            perm = list(range(len(xs)))
            for group in coll.axis_groups(mesh, axes):
                for a, b in zip(group, reversed(group)):
                    perm[a] = b
            xs = [xs[j] for j in perm]
        return real(xs, mesh, axes, split_axis, concat_axis)

    coll.all_to_all = wrong
    try:
        yield
    finally:
        coll.all_to_all = real


def moe_layer_weights(cfg, gen):
    """One MoE layer's router and experts at ``cfg``'s widths, bf16, made
    on the card from ``gen`` (fan-in scaled normals)."""
    import torch

    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def dense(*shape, fan_in):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16).mul_(fan_in ** -0.5)

    return {"router": dense(d, E, fan_in=d), "wi": dense(E, d, 2, f, fan_in=d),
            "wo": dense(E, f, d, fan_in=f)}


def a2a_block_checks(arch: str, card: str, grads: bool) -> dict:
    """Phase 3i(a): one MoE layer of ``arch`` at its published widths on
    a ``PAR_MESH`` mesh of 8 shards on the card, experts placed by
    ``place_experts`` (views of the weights), 4 x ``PAR_TOKENS`` tokens:
    for each of ``A2A_CASES`` the a2a within ``A2A_TOL`` of the per-shard
    ``moe_block`` (capacity 1.25: what expert parallelism computes) or
    of ``moe_block`` over all the tokens (capacity 8, nothing dropped),
    the reference replaying the a2a's expert choices (float32 logits
    at another matmul shape may flip a near tie); the reverse exchange
    with the shard order reversed outside it.  With ``grads``: the
    gradients of x, the router, ``wi`` and ``wo`` within ``A2A_GRAD_TOL``
    (relative L2) of the per-shard ``moe_block``'s.  Printed: the aux
    against the per-shard mean, pairs dropped, the bytes each all-to-all
    moves and ms against ``moe_block``."""
    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models import moe

    cfg = configs.get(arch)
    E, d, f, K = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe_layer_weights(cfg, gen)
    dp = PAR_MESH[0]
    T = dp * PAR_TOKENS
    x = torch.randn(T, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    mesh = make_mesh(PAR_MESH, ("data", "model"),
                     devices=["cuda:0"] * (PAR_MESH[0] * PAR_MESH[1]))
    before = torch.cuda.memory_allocated()
    placed = moe.place_experts(p, mesh, dp_axes=("data",))
    views = all(s.untyped_storage().data_ptr()
                == p[n].untyped_storage().data_ptr()
                for n in ("wi", "wo") for s in placed[n].shards)
    grown = torch.cuda.memory_allocated() - before
    nbytes = sum(p[n].numel() * 2 for n in ("wi", "wo"))
    log(f"a2a {arch}: {E} experts top-{K}, d {d}, f {f}: "
        f"{nbytes / 1e9:.2f} GB of experts; placed on {PAR_MESH} "
        f"(\"data\", \"model\") shards of cuda:0 as views: {views}, "
        f"{grown} bytes allocated by the placing")
    if not views or grown > 1 << 20:
        raise AssertionError(f"a2a {arch}: placing the experts copied them")
    chunks = list(torch.chunk(x, dp))
    out = {"cases": {}}
    for cf, rtp in A2A_CASES:
        fn = moe.make_moe_a2a(mesh, dp_axes=("data",), top_k=K,
                              capacity_factor=cf, residual_tp=rtp)
        with expert_choices() as chosen:
            y, aux = fn(placed, x)
        if cf == 8.0:
            with expert_choices(replay=[torch.cat(chosen)]):
                want, aux_all = moe.moe_block(p, x, top_k=K,
                                              capacity_factor=cf)
            what = "moe_block over all the tokens"
        else:
            with expert_choices(replay=chosen):
                parts = [moe.moe_block(p, xs, top_k=K, capacity_factor=cf)
                         for xs in chunks]
            want = torch.cat([o for o, _ in parts])
            aux_all = torch.stack([a for _, a in parts]).mean()
            what = "the per-shard moe_block"
        err, bad = outside(y, want, *A2A_TOL)
        C_l = moe.moe_capacity(PAR_TOKENS, E, K, cf)
        log(f"a2a {arch} capacity {cf} residual_tp={rtp}: C_l {C_l}, "
            f"against {what}: max |difference| {err:.4e}, {bad} outside "
            f"(atol {A2A_TOL[0]:g}, rtol {A2A_TOL[1]:g}); aux "
            f"{float(aux):.6f}, "
            f"{'over all tokens' if cf == 8.0 else 'the per-shard mean'} "
            f"{float(aux_all):.6f}")
        if bad:
            raise AssertionError(f"a2a {arch} capacity {cf} "
                                 f"residual_tp={rtp}: outside the limit")
        out["cases"][(cf, rtp)] = err
    # the wrong variant, the pairs dropped, the bytes, the times (1.25)
    fn = moe.make_moe_a2a(mesh, dp_axes=("data",), top_k=K,
                          capacity_factor=1.25, residual_tp=False)
    with expert_choices() as chosen:
        y, aux = fn(placed, x)
    with expert_choices(replay=chosen):
        want = torch.cat([moe.moe_block(p, xs, top_k=K,
                                        capacity_factor=1.25)[0]
                          for xs in chunks])
    with reverse_exchange_reversed(), expert_choices(replay=chosen):
        wrong, _ = fn(placed, x)
    werr, wbad = outside(wrong, want, *A2A_TOL)
    log(f"a2a {arch} wrong variant (the reverse exchange's shard order "
        f"reversed): max |difference| {werr:.4e}, {wbad} outside")
    if not wbad:
        raise AssertionError(f"a2a {arch}: the limit does not see the "
                             f"reverse exchange reversed")
    with dropped_pairs() as dropped:
        fn(placed, x)
    dropped = [int(n) for n in dropped]
    C_l = moe.moe_capacity(PAR_TOKENS, E, K, 1.25)
    buf_bytes = E * C_l * d * 2
    ep = PAR_MESH[0]
    moved = PAR_MESH[0] * PAR_MESH[1] * buf_bytes * (ep - 1) // ep
    a2a_ms = time_ms(lambda: fn(placed, x), iters=5, reps=3, warmup=1)
    block_ms = time_ms(lambda: moe.moe_block(p, x, top_k=K,
                                             capacity_factor=1.25),
                       iters=5, reps=3, warmup=1)
    shard_ms = time_ms(lambda: [moe.moe_block(p, xs, top_k=K,
                                              capacity_factor=1.25)
                                for xs in chunks], iters=5, reps=3,
                       warmup=1)
    log(f"a2a {arch} capacity 1.25: pairs dropped per data shard "
        f"{dropped} of {PAR_TOKENS * K} each; a bucket buffer "
        f"({E}, {C_l}, {d}) bf16 = {buf_bytes} bytes a shard, each "
        f"all_to_all moving {moved} bytes between shards "
        f"({buf_bytes * (ep - 1) // ep} a shard; copies within the card's "
        f"memory); ms a call: a2a {a2a_ms:.3f}, "
        f"moe_block over all {T} tokens {block_ms:.3f}, moe_block on each "
        f"data shard {shard_ms:.3f} ({card})")
    out.update(wrong=werr, dropped=dropped, moved=moved, a2a_ms=a2a_ms,
               block_ms=block_ms, shard_ms=shard_ms)
    if grads:
        out["grads"] = a2a_grad_gate(arch, card, p, x, mesh, K)
    return out


def a2a_grad_gate(arch: str, card: str, p, x, mesh, K: int) -> dict:
    """The a2a's gradients (capacity 1.25, ``residual_tp``, as the model
    runs it) of ``sum(y * r) + aux`` against the per-shard
    ``moe_block``'s replaying its expert choices, per tensor within
    ``A2A_GRAD_TOL`` relative L2."""
    import torch

    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(1)
    r = torch.randn(x.shape, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    fn = moe.make_moe_a2a(mesh, dp_axes=("data",), top_k=K,
                          capacity_factor=1.25, residual_tp=True)

    def grads_of(run, replay=None):
        leaves = {"x": x.detach().clone().requires_grad_(),
                  **{n: p[n].detach().requires_grad_() for n in p}}
        with expert_choices(replay=replay) as chosen:
            y, aux = run({n: leaves[n] for n in p}, leaves["x"])
            loss = (y.float() * r.float()).sum() + aux
            g = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, g)), chosen

    got, chosen = grads_of(fn)

    def per_shard(pp, xx):
        parts = [moe.moe_block(pp, xs, top_k=K, capacity_factor=1.25)
                 for xs in torch.chunk(xx, PAR_MESH[0])]
        return (torch.cat([o for o, _ in parts]),
                torch.stack([a for _, a in parts]).mean())

    want, _ = grads_of(per_shard, replay=chosen)
    rel = grad_rel_diffs(got, want)
    log(f"a2a {arch} gradients against the per-shard moe_block (capacity "
        f"1.25, residual_tp): relative L2 "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} "
        f"(limit {A2A_GRAD_TOL:g}) ({card})")
    bad = {k: v for k, v in rel.items() if not v <= A2A_GRAD_TOL}
    if bad:
        raise AssertionError(f"a2a {arch}: gradients {bad} outside the "
                             f"limit")
    return rel


def hook_prefill_checks(card: str, zero_counts, counts_now) -> dict:
    """Phase 3i(b): phi3.5-moe at its published width cut to
    ``HOOK_LAYERS`` layers, a prefill of 4 rows x ``PAR_TOKENS`` tokens
    with ``moe_a2a`` on the ``PAR_MESH`` mesh (``moe_a2a_for``, as the
    reference's ``make_ctx`` builds it): K6 once per layer for the call,
    the last-position logits within ``LOGIT_TOL`` of the port's prefill
    of each row alone without the hook (each data shard holds one row,
    so expert parallelism computes that), the rows replaying the hook's
    expert choices; printed without the replay too, with the count of
    choices that differ; the reverse exchange reversed outside it."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.launch.steps import moe_a2a_for
    from repro_torch.models.lm import init_lm, prefill

    dev = torch.device("cuda")
    arch = "phi3.5-moe"
    full = configs.get(arch)
    cfg = full.with_(n_layers=HOOK_LAYERS)
    log(f"{arch} through the hook: reduced: {HOOK_LAYERS} of "
        f"{full.n_layers} layers (the published width)")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    mesh = make_mesh(PAR_MESH, ("data", "model"),
                     devices=["cuda:0"] * (PAR_MESH[0] * PAR_MESH[1]))
    fn = moe_a2a_for(cfg, mesh)
    if fn is None:
        raise AssertionError(f"{arch}: moe_a2a_for gave no a2a on "
                             f"{PAR_MESH}")
    rows = PAR_MESH[0]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (rows, PAR_TOKENS)).astype(np.int32)).to(dev)
    max_seq = PAR_TOKENS + 1

    def hooked():
        return prefill(params, {"tokens": tokens}, cfg, max_seq=max_seq,
                       moe_a2a=fn)[0].float()

    hooked()                                           # warm-up
    torch.cuda.synchronize()
    zero_counts()
    with expert_choices() as chosen:
        got = hooked()
    counts = counts_now()
    if counts["flash_attention"] != HOOK_LAYERS or counts["ssd_intra_chunk"]:
        raise AssertionError(f"{arch} through the hook: launches {counts}, "
                             f"expected flash_attention {HOOK_LAYERS}")
    if tuple(got.shape) != (rows, cfg.padded_vocab()) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{arch} through the hook: logits of shape "
                             f"{tuple(got.shape)}, or not finite")

    def each_row(replay=None):
        outs, routes = [], []
        for b in range(rows):
            with expert_choices(replay=replay,
                                order=lambda i, b=b: i * rows + b) as ch:
                outs.append(prefill(params, {"tokens": tokens[b:b + 1]},
                                    cfg, max_seq=max_seq)[0].float())
            routes.append(ch)
        return torch.cat(outs), routes

    want, _ = each_row(replay=chosen)
    free, free_routes = each_row()
    err = float((got - want).abs().max())
    free_err = float((got - free).abs().max())
    differ = sum(int((chosen[i * rows + b] != free_routes[b][i])
                     .any(dim=-1).sum())
                 for b in range(rows) for i in range(HOOK_LAYERS))
    with reverse_exchange_reversed():
        wrong = hooked()
    werr = float((wrong - want).abs().max())
    hook_ms = time_ms(hooked, iters=3, reps=3, warmup=1)
    rows_ms = time_ms(lambda: each_row(), iters=2, reps=3, warmup=1)
    log(f"{arch} prefill of {rows} x {PAR_TOKENS} tokens through moe_a2a "
        f"on {PAR_MESH}: K6 {counts['flash_attention']} launches (one a "
        f"layer); last-position logits against each row alone replaying "
        f"the hook's expert choices: max |difference| {err:.4e} (limit "
        f"{LOGIT_TOL[arch]:g}, max |x| {float(want.abs().max()):.3f}); "
        f"without the replay {free_err:.4e}, {differ} of "
        f"{rows * PAR_TOKENS * HOOK_LAYERS} (token, layer) choices differ;"
        f" the reverse exchange reversed {werr:.4e}; ms: through the hook "
        f"{hook_ms:.3f}, the rows alone {rows_ms:.3f} ({card})")
    if not err <= LOGIT_TOL[arch]:
        raise AssertionError(f"{arch} through the hook: logits outside the "
                             f"limit")
    if not werr > LOGIT_TOL[arch]:
        raise AssertionError(f"{arch} through the hook: the limit does not "
                             f"see the reverse exchange reversed")
    return {"counts": counts, "err": err, "free_err": free_err,
            "differ": differ, "wrong": werr, "hook_ms": hook_ms,
            "rows_ms": rows_ms}


def seqpar_checks(card: str) -> dict:
    """Phase 3i(c): sequence parallelism on a ("sp",) mesh of
    ``SP_SHARDS`` on the card.  The conv halo: mamba2-130m's conv input
    (its x, B and C streams), B ``SP_CONV_BATCH``, ``SP_SHARDS`` x
    ``SP_SEQ`` tokens: ``causal_conv1d`` per shard with the halo as its
    prefix bit for bit the unsharded conv (zero halos differ).  The scan
    carry: recurrentgemma-9b's RG-LRU width, B ``SP_SCAN_BATCH``, decays
    in (0.998, 1): per-shard ``linear_scan`` from zero, then
    ``seqpar_scan_carry``: each shard's carried last state within
    ``SP_CARRY_TOL`` of the unsharded scan's; a carry without the
    shard's decay product outside."""
    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models.ssm import (causal_conv1d, linear_scan,
                                        seqpar_conv_halo, seqpar_scan_carry)

    mesh = make_mesh((SP_SHARDS,), ("sp",), devices=["cuda:0"] * SP_SHARDS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    mcfg = configs.get("mamba2-130m")
    C = mcfg.padded_ssm_heads() * mcfg.ssm_head_dim + 2 * mcfg.ssm_state
    K = mcfg.d_conv
    S = SP_SHARDS * SP_SEQ
    x = torch.randn(SP_CONV_BATCH, S, C, generator=gen, device="cuda",
                    dtype=mcfg.compute_torch_dtype)
    w = torch.randn(C, K, generator=gen, device="cuda").mul_(K ** -0.5).to(
        mcfg.param_torch_dtype)
    shards = list(torch.chunk(x, SP_SHARDS, dim=1))
    halos = seqpar_conv_halo(shards, mesh, width=K - 1, axis_name="sp")
    got = torch.cat([causal_conv1d(s, w, prefix=h)
                     for s, h in zip(shards, halos)], dim=1)
    want = causal_conv1d(x, w)
    zero = torch.cat([causal_conv1d(s, w) for s in shards], dim=1)
    same = torch.equal(got, want)
    zdiff = int((zero != want).sum())
    log(f"seqpar conv halo: mamba2-130m's conv input ({SP_CONV_BATCH}, "
        f"{SP_SHARDS} x {SP_SEQ}, {C}) {x.dtype}, width {K - 1}: bit for "
        f"bit the unsharded conv: {same}; zero halos differ in {zdiff} "
        f"values")
    if not same or not zdiff:
        raise AssertionError("seqpar conv halo: not the unsharded conv, or "
                             "the check does not see zero halos")
    del x, shards, halos, got, want, zero
    R = configs.get("recurrentgemma-9b").lru_width
    a = torch.rand(SP_SCAN_BATCH, S, R, generator=gen, device="cuda") \
        .mul_(0.002).add_(0.998)
    b = torch.randn(SP_SCAN_BATCH, S, R, generator=gen, device="cuda")
    want = linear_scan(a, b)[:, SP_SEQ - 1::SP_SEQ]        # (B, shards, R)
    a_s, b_s = torch.chunk(a, SP_SHARDS, dim=1), torch.chunk(b, SP_SHARDS,
                                                             dim=1)
    h_local = [linear_scan(x_, y_)[:, -1] for x_, y_ in zip(a_s, b_s)]
    a_total = [x_.prod(dim=1) for x_ in a_s]
    inc = seqpar_scan_carry(a_total, h_local, mesh, axis_name="sp")
    last = torch.stack([c * t + h for c, t, h in zip(inc, a_total,
                                                     h_local)], dim=1)
    wrong = torch.stack([c + h for c, h in zip(inc, h_local)], dim=1)
    atol = SP_CARRY_TOL * float(want.abs().max())
    err, bad = outside(last, want, atol, SP_CARRY_TOL)
    werr, wbad = outside(wrong, want, atol, SP_CARRY_TOL)
    log(f"seqpar scan carry: RG-LRU width {R} ({SP_SCAN_BATCH}, "
        f"{SP_SHARDS} x {SP_SEQ}) float32, decay products "
        f"{[round(float(t.mean()), 4) for t in a_total]}: carried last "
        f"states against the unsharded scan max |difference| {err:.4e}, "
        f"{bad} outside (rtol {SP_CARRY_TOL:g}, atol {atol:.3e}); without "
        f"the decay product {werr:.4e}, {wbad} outside ({card})")
    if bad or not wbad:
        raise AssertionError("seqpar scan carry: outside the limit, or the "
                             "limit does not see a carry without the decay")
    return {"conv_equal": same, "carry_err": err, "carry_wrong": werr}


def compressed_psum_checks(card: str) -> dict:
    """Phase 3i(d): ``compressed_psum`` on a ("data",) mesh of
    ``CPSUM_SHARDS`` on the card over a gradient tree shaped like
    mamba2-130m's parameters, float32, seeded per shard:
    ``CPSUM_STEPS`` steps with error feedback, the time-averaged mean
    within ``CPSUM_TOL`` of the true mean; every int32 payload sum equal
    to a float64 sum of the payloads.  Printed: payload bytes against
    float32's, ms a call."""
    import torch

    from repro_torch import configs
    from repro_torch.core import collectives as coll
    from repro_torch.core import make_mesh
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import ErrorFeedbackState, compressed_psum

    dev = torch.device("cuda")
    mcfg = configs.get("mamba2-130m")
    shapes = {n: p.shape for n, p in init_lm(
        mcfg, torch.Generator(device=dev).manual_seed(0),
        dev).named_parameters()}
    mesh = make_mesh((CPSUM_SHARDS,), ("data",),
                     devices=["cuda:0"] * CPSUM_SHARDS)
    grads = {n: [] for n in shapes}
    for i in range(CPSUM_SHARDS):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        for n, shape in shapes.items():
            grads[n].append(torch.randn(shape, generator=gen, device=dev))
    numel = sum(g[0].numel() for g in grads.values())
    real = coll.psum
    sums = [0, 0]

    def checked(xs, mesh_, axes):
        out = real(xs, mesh_, axes)
        if xs[0].dtype == torch.int32 and sums[0] < len(shapes):
            # the first step's payload sums, each against float64's
            ref = torch.stack([x.double() for x in xs]).sum(dim=0)
            sums[0] += 1
            sums[1] += int(not torch.equal(out[0].double(), ref))
        return out

    ef = ErrorFeedbackState.init(grads)
    total = {n: torch.zeros(s, device=dev) for n, s in shapes.items()}
    coll.psum = checked
    try:
        for _ in range(CPSUM_STEPS):
            mean, ef = compressed_psum(grads, mesh, "data", ef=ef)
            for n in total:
                total[n] += mean[n][0]
    finally:
        coll.psum = real
    err = max(float((total[n] / CPSUM_STEPS
                     - torch.stack(grads[n]).mean(dim=0)).abs().max())
              for n in total)
    call_ms = time_ms(lambda: compressed_psum(grads, mesh, "data", ef=ef),
                      iters=3, reps=3, warmup=1)
    payload = numel + 4 * len(shapes)
    log(f"compressed_psum on ({CPSUM_SHARDS},) \"data\": {len(shapes)} "
        f"tensors, {numel} float32 values a shard (mamba2-130m's "
        f"parameters): {CPSUM_STEPS} steps with error feedback, the "
        f"time-averaged mean within {err:.4e} of the true mean (limit "
        f"{CPSUM_TOL:g}); the first step's {sums[0]} int32 payload sums, "
        f"{sums[1]} unequal to the float64 sum; payload {payload} bytes a "
        f"shard against {4 * numel} in float32 "
        f"({4 * numel / payload:.2f}x less); "
        f"{call_ms:.3f} ms a call ({card})")
    if not err <= CPSUM_TOL or sums[1] or not sums[0]:
        raise AssertionError("compressed_psum: the mean outside the limit, "
                             "or an int32 sum unequal to float64's")
    return {"err": err, "call_ms": call_ms, "payload": payload,
            "f32_bytes": 4 * numel}


def parallel_phase(card: str, zero_counts, counts_now) -> dict:
    """Phase 3i: explicit collectives on meshes of shards on the card:
    the MoE all-to-all (``a2a_block_checks`` for phi3.5-moe with its
    gradients, then arctic-480b), phi3.5-moe's prefill through the hook
    (``hook_prefill_checks``), sequence parallelism (``seqpar_checks``)
    and ``compressed_psum`` (``compressed_psum_checks``).  Returns the
    readings and the hook prefill's K6 launches."""
    import torch

    t0 = time.perf_counter()
    out = {"phi": a2a_block_checks("phi3.5-moe", card, grads=True)}
    gc.collect()
    torch.cuda.empty_cache()
    out["arctic"] = a2a_block_checks("arctic-480b", card, grads=False)
    gc.collect()
    torch.cuda.empty_cache()
    out["hook"] = hook_prefill_checks(card, zero_counts, counts_now)
    out["launches"] = {"flash_attention":
                       out["hook"]["counts"]["flash_attention"]}
    gc.collect()
    torch.cuda.empty_cache()
    out["seqpar"] = seqpar_checks(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["cpsum"] = compressed_psum_checks(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["secs"] = time.perf_counter() - t0
    log(f"phase 3i: {out['secs']:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated "
        f"({card})")
    return out


def main() -> int:
    # phase 3f runs under torch.use_deterministic_algorithms, which needs
    # cuBLAS's deterministic workspace setting before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    import numpy as np

    from repro_torch.core import (Boundary, Executor, Layout, RecordArray,
                                  Reducer, pad_boundary_only, relayout)
    from repro_torch.kernels import _build
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.particle.ops import (PARTICLE_SPEC,
                                                  particle_update_ref)
    from repro_torch.kernels.saxpy.kernel import (saxpy_cuda,
                                                  saxpy_record_cuda)
    from repro_torch.kernels.saxpy.ops import (SAXPY_SPEC, saxpy_record_ref,
                                               saxpy_ref)
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.eikonal.ops import eikonal_fim_ref
    from repro_torch.kernels.stencil.kernel import (flux_difference_cuda,
                                                    flux_traffic_cuda)
    from repro_torch.kernels.stencil.ops import (flux_difference,
                                                 flux_difference_ref)
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init
    from repro_torch import workloads
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ref import mha_ref
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
    from repro_torch.kernels.reduce.kernel import nan_ignoring_extremum_cuda
    from repro_torch.kernels.reduce.ref import nan_ignoring_extremum_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {', '.join(f'{k}.cu {v:.1f}s' for k, v in secs.items())} "
        f"(wall {time.perf_counter() - t0:.1f}s, into {_build.BUILD_DIR})")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        advisories = 0
        for line in report.read_text().splitlines():
            if "C7519" in line:   # "warpgroup.arrive is injected", one a wgmma
                advisories += 1
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
        if advisories:
            log(f"ptxas {name}: {advisories} advisories C7519 (a wgmma fence "
                f"injected by the compiler)")

    kernels = {  # name -> JSON entry
        "saxpy": {"source": "src/repro_torch/csrc/saxpy.cu",
                  "replaces": "src/repro/kernels/saxpy/kernel.py:61"},
        "saxpy_record": {"source": "src/repro_torch/csrc/saxpy.cu",
                         "replaces": "src/repro/kernels/saxpy/kernel.py:112"},
        "particle_update": {
            "source": "src/repro_torch/csrc/particle.cu",
            "replaces": "src/repro/kernels/particle/kernel.py:59"},
        "flux_difference": {
            "source": "src/repro_torch/csrc/stencil.cu",
            "replaces": "src/repro/kernels/stencil/kernel.py:67"},
        "eikonal_fim": {
            "source": "src/repro_torch/csrc/eikonal.cu",
            "replaces": "src/repro/kernels/eikonal/kernel.py:84"},
        "flash_attention": {
            "source": "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention/kernel.py:132"},
        "ssd_intra_chunk": {
            "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:72"},
        # no Pallas kernel: the JAX package's max/min reduce with jnp
        "nan_ignoring_extremum": {
            "source": "src/repro_torch/csrc/reduce.cu",
            "replaces": "src/repro/core/graph.py:186"},
    }
    wrappers = {"saxpy": saxpy_cuda, "saxpy_record": saxpy_record_cuda,
                "particle_update": particle_update_cuda,
                "flux_difference": flux_difference_cuda,
                "eikonal_fim": eikonal_fim_cuda,
                "flash_attention": flash_attention_cuda,
                "ssd_intra_chunk": ssd_intra_chunk_cuda,
                "nan_ignoring_extremum": nan_ignoring_extremum_cuda}
    errs = {k: 0.0 for k in kernels}
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def haloed_shock_bubble(dtype):
        """The flux kernel's input: the shock-bubble state in ``dtype``
        with a one-cell transmissive halo, (4, FLUX_N+2, FLUX_N+2)."""
        u = shock_bubble_init(FLUX_N, FLUX_N, device=dev).to(dtype)
        for ax in (1, 2):
            u = pad_boundary_only(u, axis=ax, width=1,
                                  boundary=Boundary.TRANSMISSIVE)
        return u

    def attn_inputs(dtype):
        """q, k, v at the qwen3-8b prefill shape."""
        B, Hq, Hkv, S, D = ATTN_SHAPE
        return (randn(B, Hq, S, D, dtype=dtype),
                randn(B, Hkv, S, D, dtype=dtype),
                randn(B, Hkv, S, D, dtype=dtype))

    def ssd_inputs(dtype):
        """x, dt, A, B, C at the mamba2-130m prefill shape (dt and A as
        the model makes them: softplus range, -(1 .. 16))."""
        B, S, H, P, N, _ = SSD_SHAPE
        dt = torch.rand(B, S, H, generator=gen, device=dev) * 0.099 + 1e-3
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        return (randn(B, S, H, P, dtype=dtype), dt, A,
                randn(B, S, N, dtype=dtype), randn(B, S, N, dtype=dtype))

    def halo(p):
        """A one-cell transmissive halo around a 2-d field."""
        for ax in (0, 1):
            p = pad_boundary_only(p, axis=ax, width=1,
                                  boundary=Boundary.TRANSMISSIVE)
        return p

    eik = workloads.eikonal_inputs(EIK_N)
    eik = {k: torch.from_numpy(v).to(dev) for k, v in eik.items()}
    # the eikonal kernel's input: the solve's state after EIK_WARM float32
    # iterations of the plain sweep (fronts in flight across tile edges)
    eik_mid = eik["phi"]
    for _ in range(EIK_WARM):
        eik_mid = eikonal_fim_ref(halo(eik_mid), eik["mask"], 1 / EIK_N,
                                  inner=EIK_INNER, block=EIK_BLOCK)
    eik_mid = halo(eik_mid)

    # -- 2. kernel parity on the card ----------------------------------------
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        tol = TOL[dname]
        for n in (SAXPY_N, SAXPY_N + 3):
            x, y = randn(n, dtype=dt), randn(n, dtype=dt)
            want = saxpy_ref(SAXPY_A, x, y)
            for bc in (True, False):
                e = max_err(saxpy_cuda(SAXPY_A, x, y, bounds_check=bc), want,
                            tol, f"saxpy {dname} n={n} "
                                 f"{'BC' if bc else 'NBC'}")
                if dname == "float32":
                    errs["saxpy"] = max(errs["saxpy"], e)
        for lay in Layout:
            rec = RecordArray(randn(2, PARTICLE_N, dtype=dt), SAXPY_SPEC,
                              Layout.SOA).with_layout(lay)
            e = max_err(saxpy_record_cuda(rec, workloads.DT).data,
                        saxpy_record_ref(rec, workloads.DT).data, tol,
                        f"saxpy_record {dname} {lay.name}")
            rec = RecordArray(randn(6, PARTICLE_N, dtype=dt), PARTICLE_SPEC,
                              Layout.SOA).with_layout(lay)
            e2 = max_err(particle_update_cuda(rec, workloads.DT).data,
                         particle_update_ref(rec, workloads.DT).data, tol,
                         f"particle_update {dname} {lay.name}")
            if dname == "float32":
                errs["saxpy_record"] = max(errs["saxpy_record"], e)
                errs["particle_update"] = max(errs["particle_update"], e2)
        u = haloed_shock_bubble(dt)
        for lay in Layout:   # AoSoA goes through the ops relayout
            rec = relayout(RecordArray(u, EULER_SPEC, Layout.SOA), lay)
            e = max_err(flux_difference(rec, *FLUX_PARITY_LAM).data,
                        flux_difference_ref(rec, *FLUX_PARITY_LAM).data,
                        FLUX_TOL[dname], f"flux_difference {dname} "
                                         f"{lay.name} λ={FLUX_PARITY_LAM}")
            if dname == "float32":
                errs["flux_difference"] = max(errs["flux_difference"], e)
            del rec
        del u
        phi = eik_mid.to(dt)
        for inner in (1, EIK_INNER):
            for tile in (EIK_BLOCK, (64, 256)):
                want = eikonal_fim_ref(phi, eik["mask"], 1 / EIK_N,
                                       inner=inner, block=tile)
                e = max_err(eikonal_fim_cuda(phi, eik["mask"], 1 / EIK_N,
                                             inner=inner, block=tile),
                            want, EIK_TOL[dname][0],
                            f"eikonal_fim {dname} inner={inner} tile={tile}",
                            rtol=EIK_TOL[dname][1])
                if dname == "float32":
                    errs["eikonal_fim"] = max(errs["eikonal_fim"], e)
        # what the bfloat16 limit can see: two deliberately wrong variants
        # against the same plain result (inner 4, the main path's tile)
        if dname == "bfloat16":
            want = eikonal_fim_ref(phi, eik["mask"], 1 / EIK_N,
                                   inner=EIK_INNER, block=EIK_BLOCK)
            wrong = {
                "one sweep short": eikonal_fim_cuda(
                    phi, eik["mask"], 1 / EIK_N, inner=EIK_INNER - 1,
                    block=EIK_BLOCK),
                "float32 tile, rounded once at the end": eikonal_fim_cuda(
                    phi.float(), eik["mask"], 1 / EIK_N, inner=EIK_INNER,
                    block=EIK_BLOCK).to(dt)}
            for what, got in wrong.items():
                err, bad = outside(got, want, *EIK_TOL[dname])
                log(f"eikonal_fim bfloat16 wrong variant ({what}): "
                    f"max_abs_err={err:.3e}, {bad} values outside the limit")
                if what == "one sweep short" and not bad:
                    raise AssertionError("eikonal bfloat16 limit does not "
                                         "see a missing sweep")
        del phi
        # K6 at the qwen3-8b prefill shape: causal, a window, a query
        # offset (the last 512 queries of 2048 keys), fused AoS KV
        q, k, v = attn_inputs(dt)
        S = ATTN_SHAPE[3]
        cases = {
            "causal": (flash_attention_cuda(q, k, v), mha_ref(q, k, v)),
            "window 1024": (flash_attention_cuda(q, k, v, window=1024),
                            mha_ref(q, k, v, window=1024)),
            "q_offset 1536": (
                flash_attention_cuda(q[:, :, -512:], k, v, q_offset=S - 512),
                mha_ref(q[:, :, -512:], k, v, q_offset=S - 512)),
            "fused AoS KV": (flash_attention_cuda(
                q, torch.stack([k, v], dim=3).contiguous()),
                mha_ref(q, k, v))}
        lim = LM_KERNEL_TOL["flash_attention"][dname]
        for what, (got, want) in cases.items():
            e = max_err(got, want, lim[0], f"flash_attention {dname} {what}",
                        rtol=lim[1])
            if dname == "float32":
                errs["flash_attention"] = max(errs["flash_attention"], e)
        if dname == "bfloat16":
            check_wrong("flash_attention", lim, cases["causal"][1], {
                "accumulator rounded to bfloat16 after each 64-key tile":
                    attn_wrong_bf16(q, k, v, "accumulator"),
                "P rounded once to bfloat16 before P·V":
                    attn_wrong_bf16(q, k, v, "P")})
        del q, k, v, cases, got, want
        x, dts, A, Bm, C = ssd_inputs(dt)
        chunk = SSD_SHAPE[-1]
        got = ssd_intra_chunk_cuda(x, dts, A, Bm, C, chunk=chunk)
        want = ssd_intra_chunk_ref(x, dts, A, Bm, C, chunk=chunk)
        for part, g_, w_ in zip(("y_intra", "chunk states"), got, want):
            lim = LM_KERNEL_TOL[f"ssd_intra_chunk {part}"][dname]
            e = max_err(g_, w_, lim[0], f"ssd_intra_chunk {dname} {part}",
                        rtol=lim[1])
            if dname == "float32":
                errs["ssd_intra_chunk"] = max(errs["ssd_intra_chunk"], e)
        if dname == "bfloat16":
            check_wrong("ssd_intra_chunk y_intra",
                        LM_KERNEL_TOL["ssd_intra_chunk y_intra"][dname],
                        want[0], {
                            "y_intra summed in bfloat16":
                                ssd_bf16_sum(x, dts, A, Bm, C, chunk),
                            "S' rounded once to bfloat16 before S' x":
                                ssd_rejected_bf16(x, dts, A, Bm, C, chunk,
                                                  "y_intra")})
            check_wrong("ssd_intra_chunk chunk states",
                        LM_KERNEL_TOL["ssd_intra_chunk chunk states"][dname],
                        want[1], {
                            "state weights rounded once to bfloat16":
                                ssd_rejected_bf16(x, dts, A, Bm, C, chunk,
                                                  "chunk states")})
        # the tile registry's chunk of 256: two 128-row tiles a block.  A
        # kernel that dropped what tile 1 takes from tile 0 would return
        # y_intra at chunk 128 and the states of each chunk's second half
        got = ssd_intra_chunk_cuda(x, dts, A, Bm, C, chunk=SSD_CHUNK_256)
        want = ssd_intra_chunk_ref(x, dts, A, Bm, C, chunk=SSD_CHUNK_256)
        y_128, s_128 = ssd_intra_chunk_ref(x, dts, A, Bm, C, chunk=chunk)
        half = (y_128, s_128[:, 1::2])
        for part, g_, w_, h_ in zip(("y_intra", "chunk states"), got, want,
                                    half):
            lim = LM_KERNEL_TOL[f"ssd_intra_chunk {part}"][dname]
            e = max_err(g_, w_, lim[0], f"ssd_intra_chunk {dname} {part} "
                                        f"chunk {SSD_CHUNK_256}",
                        rtol=lim[1])
            if dname == "float32":
                errs["ssd_intra_chunk"] = max(errs["ssd_intra_chunk"], e)
            err, bad = outside(h_, w_, *lim)
            log(f"ssd_intra_chunk {dname} {part} chunk {SSD_CHUNK_256} "
                f"wrong variant (tile 1 without tile 0): max_abs_err="
                f"{err:.3e}, {bad} values outside the limit")
            if not bad:
                raise AssertionError(f"ssd_intra_chunk {part}: the limit "
                                     f"does not see a chunk of 256 cut in "
                                     f"two")
        del x, dts, A, Bm, C, got, want, y_128, s_128, half
        torch.cuda.empty_cache()
    # the NaN-ignoring max/min at the main path's views: the ions' AoS v
    # (a 6-float record's field at offset 3) and the eikonal solve's change
    # (x, between the records' v, holds +-1e30: the read must skip it)
    ions = RecordArray(torch.empty(6, PARTICLE_N, device=dev),
                       PARTICLE_SPEC, Layout.SOA).with_layout(Layout.AOS)
    x_of = ions.field("x")
    x_of[0::2], x_of[1::2] = 1e30, -1e30
    aos_v = ions.field("v")
    if aos_v.stride() != (6, 1) or aos_v.storage_offset() != 3 \
            or x_of.data_ptr() != aos_v.data_ptr() - 12:
        raise AssertionError(f"the ions' AoS v is {aos_v.stride()} at "
                             f"{aos_v.storage_offset()}, not (6, 1) at 3 "
                             f"beside x")
    errs["nan_ignoring_extremum"] = extremum_parity({
        "ions' AoS v": aos_v,
        "eikonal change": torch.empty(EIK_N, EIK_N, device=dev)})
    del ions, x_of, aos_v
    torch.cuda.empty_cache()
    # K6 at head dim 256: gemma3-12b's and recurrentgemma-9b's prefills
    errs["flash_attention"] = max(errs["flash_attention"],
                                  local_attention_parity())
    # ... and at phase 3g's and 3h's shapes: MHA 20/20, GQA 32/2, head
    # dim 64 without a mask, 512 queries against 4096 keys, GQA 56/8
    errs["flash_attention"] = max(errs["flash_attention"],
                                  serving_attention_parity())

    # -- 3. the main path through Graph/Executor on the GPU ------------------
    wall = {}
    path_launches = {}   # graph -> kernel -> launches in that graph's run

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts(path):
        path_launches[path] = {k: w.launches for k, w in wrappers.items()}

    def at_defaults(name, g, inp, steps, want):
        """The graph through ``Executor(g)`` at the executor's defaults
        (regions, donation): the wrappers called twice a kernel call site
        by the build (its eager warm-up and its capture) and never by a
        replay; the state bit for bit ``want`` (the ``regions=False``
        run's); its ms per step, and the device memory at its peak."""
        torch.cuda.reset_peak_memory_stats()
        ex = Executor(g)
        if not (ex.regions and ex.donate):
            raise AssertionError("Executor(g) is not at regions=True, "
                                 "donate=True")
        zero_counts()
        state, ms = run_steps(ex, ex.init_state(**inp), steps)
        read_counts(f"{name} (defaults)")
        expect[f"{name} (defaults)"] = {
            k: 2 * n for k, n in REGION_KERNELS[name].items()}
        check_bits(f"main path {name} at the defaults", state, want)
        wall_defaults[name] = ms
        log(f"main path {name} at the defaults: bit for bit the "
            f"regions=False run's; {ms:.3f} ms per step (median of "
            f"{steps}), regions=False {wall[name]:.3f}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"allocated ({card})")

    expect = {}
    wall_defaults = {}
    g, (x_t, y_bc, y_nbc) = workloads.build_saxpy_graph(SAXPY_N, SAXPY_A)
    ex = Executor(g, regions=False)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(SAXPY_N, dtype=np.float32)
    state = ex.init_state(x=x0)
    zero_counts()
    state, wall["saxpy_probe"] = run_steps(ex, state, SAXPY_STEPS)
    read_counts("saxpy_probe")
    at_defaults("saxpy_probe", g, {"x": x0}, SAXPY_STEPS, state)
    want = torch.from_numpy(x0).to(dev)
    acc = torch.zeros_like(want)
    for _ in range(SAXPY_STEPS):
        acc = SAXPY_A * want + acc
    for t in (y_bc, y_nbc):
        max_err(state[t.name], acc, 1e-5, f"main path saxpy probe {t.name}")
    del state, ex, want, acc

    g, (ions, electrons, field), vmax = workloads.build_particle_graph(
        PARTICLE_N)
    ex = Executor(g, regions=False)
    fields = workloads.particle_fields(PARTICLE_N)
    specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
             "electrons": (PARTICLE_SPEC, Layout.AOSOA),
             "field": (SAXPY_SPEC, Layout.SOA)}
    inp = {
        k: RecordArray.from_fields(spec, {f: torch.from_numpy(v).to(dev)
                                          for f, v in fields[k].items()},
                                   lay)
        for k, (spec, lay) in specs.items()}
    state = ex.init_state(**inp)
    zero_counts()
    state, wall["particle_step"] = run_steps(ex, state, PARTICLE_STEPS)
    read_counts("particle_step")
    at_defaults("particle_step", g, inp, PARTICLE_STEPS, state)
    del inp
    span = PARTICLE_STEPS * workloads.DT
    for t, key in ((ions, "ions"), (electrons, "electrons")):
        x_t0 = torch.from_numpy(fields[key]["x"]).to(dev)
        v_t0 = torch.from_numpy(fields[key]["v"]).to(dev)
        max_err(ex.read(state, t).field("x"), x_t0 + span * v_t0, 1e-4,
                f"main path {key} x_T = x_0 + T dt v")
    max_err(ex.read(state, field).field("y"),
            span * torch.from_numpy(fields["field"]["x"]).to(dev), 1e-4,
            "main path field y_T = T dt x")
    v_ions = torch.from_numpy(fields["ions"]["v"]).to(dev)
    max_err(state[vmax.name], v_ions.max(), 0.0, "main path vmax")
    del state, ex, fields, x_t0, v_t0, v_ions

    g, (u_t, flux_t) = workloads.build_flux_graph(FLUX_N, FLUX_N,
                                                  lam_x=FLUX_LAM,
                                                  lam_y=FLUX_LAM)
    ex = Executor(g, regions=False)
    u0 = shock_bubble_init(FLUX_N, FLUX_N, device=dev)
    state = ex.init_state(u=u0)
    zero_counts()
    state, wall["flux"] = run_steps(ex, state, FLUX_STEPS)
    read_counts("flux")
    at_defaults("flux", g, {"u": u0}, FLUX_STEPS, state)
    plain_g, _ = workloads.build_flux_graph(FLUX_N, FLUX_N, lam_x=FLUX_LAM,
                                            lam_y=FLUX_LAM, use_kernel=False)
    plain_ex = Executor(plain_g, regions=False)
    plain = plain_ex(plain_ex.init_state(u=u0))
    max_err(state[flux_t.name], plain[flux_t.name], FLUX_TOL["float32"],
            "main path flux graph vs plain graph")
    del state, plain, plain_ex, ex

    def solve_eikonal(use_kernel: bool, **opts):
        """One eikonal solve through ``Executor(g, **opts)``; returns the
        final state, the iteration count, the solve's wall time and the
        median wall time of one iteration (each ended by the predicate's
        device-to-host read)."""
        g, _, converging = workloads.build_eikonal_graph(
            EIK_N, inner=EIK_INNER, block=EIK_BLOCK, max_iters=4 * EIK_N,
            use_kernel=use_kernel)
        body = g.levels[0][0].subgraph
        if not use_kernel:   # the plain loop's max: the torch route
            for node in body.nodes():
                if node.kind == "reduce":
                    node.reducer = Reducer("max", functools.partial(
                        nan_ignoring_extremum_ref, largest=True), "max")
        stamps = []

        def timed(state):
            go = converging(state)
            stamps.append(time.perf_counter())
            return go

        body.conditional(timed)
        ex = Executor(g, **opts)
        state = ex.init_state(**eik)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ex(state)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        per_iter = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return state, converging.iterations, solve_s, \
            statistics.median(per_iter)

    zero_counts()
    state, iters, solve_s, iter_ms = solve_eikonal(True, regions=False)
    read_counts("eikonal_solve")
    wall["eikonal_solve"] = iter_ms
    zero_counts()
    got, d_iters, d_solve_s, d_iter_ms = solve_eikonal(True)
    read_counts("eikonal_solve (defaults)")
    expect["eikonal_solve (defaults)"] = {
        k: 2 * n for k, n in REGION_KERNELS["eikonal_solve"].items()}
    if d_iters != iters:
        raise AssertionError(f"eikonal solve at the defaults: {d_iters} "
                             f"iterations, {iters} with regions=False")
    check_bits("main path eikonal_solve at the defaults", got, state)
    wall_defaults["eikonal_solve"] = d_iter_ms
    log(f"main path eikonal_solve at the defaults: bit for bit the "
        f"regions=False solve's in {d_iters} iterations; solve "
        f"{d_solve_s:.3f} s, {d_iter_ms:.3f} ms per iteration (median), "
        f"regions=False {solve_s:.3f} s, {iter_ms:.3f} ms ({card})")
    del got
    plain, plain_iters, plain_s, plain_iter_ms = solve_eikonal(
        False, regions=False)
    log(f"main path eikonal_solve: {iters} iterations, solve {solve_s:.3f} "
        f"s, {iter_ms:.3f} ms per iteration (median); plain loop "
        f"{plain_iters} iterations, {plain_s:.3f} s, {plain_iter_ms:.3f} ms "
        f"per iteration ({card})")
    if not 0 < iters == plain_iters:
        raise AssertionError(f"eikonal solve: {iters} iterations with the "
                             f"kernel, {plain_iters} with the plain version")
    if float(state["res"]) != 0.0:
        raise AssertionError("eikonal solve ended with res != 0")
    max_err(state["phi"], plain["phi"], EIK_TOL["float32"][0],
            "main path eikonal solve vs plain loop",
            rtol=EIK_TOL["float32"][1])
    dist = torch.from_numpy(workloads.eikonal_distance(EIK_N)).to(dev)
    band = dist < 0.1
    band_err = float((state["phi"].double() - dist)[band].abs().max())
    log(f"main path eikonal closed form: max |phi - h|r - R|| in the band "
        f"= {band_err:.3e} = {band_err * EIK_N:.3f} h (limit 3 h)")
    if not band_err <= 3.0 / EIK_N:
        raise AssertionError("eikonal solve: more than 3h from the exact "
                             "distance in the band")
    del state, plain, dist, band

    expect.update({
        "saxpy_probe": {"saxpy": 2 * SAXPY_STEPS},
        "particle_step": {"saxpy_record": PARTICLE_STEPS,
                          "particle_update": 2 * PARTICLE_STEPS,
                          "nan_ignoring_extremum": PARTICLE_STEPS},
        "flux": {"flux_difference": FLUX_STEPS},
        "eikonal_solve": {"eikonal_fim": iters,
                          "nan_ignoring_extremum": iters}})
    launches = {k: 0 for k in wrappers}
    for path, counts in list(path_launches.items()):
        log(f"main path launches {path}: {json.dumps(counts)}")
        for k, n in counts.items():
            if n != expect[path].get(k, 0):
                raise AssertionError(f"{k}: {n} launches in {path}, "
                                     f"expected {expect[path].get(k, 0)}")
            launches[k] += n
    for k, ms in wall.items():
        log(f"wall per step {k} (median): {ms:.3f} ms at regions=False, "
            f"{wall_defaults[k]:.3f} ms at the defaults ({card})")

    # where the solve's time goes: device time by kernel over one more
    # whole solve under torch.profiler, against the unprofiled wall time
    g, _, _ = workloads.build_eikonal_graph(
        EIK_N, inner=EIK_INNER, block=EIK_BLOCK, max_iters=4 * EIK_N)
    ex = Executor(g, regions=False)
    state = ex.init_state(**eik)
    torch.cuda.synchronize()
    kernel_us = device_time_by_kernel(lambda: ex(state))
    busy_ms = sum(us for us, _ in kernel_us.values()) / 1e3
    if busy_ms == 0.0:
        log("eikonal_solve device time: not measured (the profiler saw no "
            "device activity)")
    else:
        log(f"eikonal_solve device time: {busy_ms:.3f} ms in all, "
            f"{busy_ms / iters:.4f} ms per iteration; busy "
            f"{100 * busy_ms / (1e3 * solve_s):.1f} % of the unprofiled "
            f"solve's wall time ({card})")
        top = sorted(kernel_us.items(), key=lambda kv: -kv[1][0])[:8]
        for name, (us, count) in top:
            log(f"  {us / 1e3 / iters:.4f} ms per iteration, {count} "
                f"launches: {name[:100]}")
    del state, ex
    torch.cuda.empty_cache()

    # the measured autotuner over the particle and flux graphs, under a
    # fresh cache.  The eikonal solve is left out: one timed call of a
    # loop graph runs TUNE_STEPS whole solves of 745 iterations (~1.1 s),
    # about 8 s a candidate; the CPU tests tune a loop graph
    from repro_torch.tuning import cache as tune_cache

    shutil.rmtree(TUNE_CACHE, ignore_errors=True)
    os.environ["REPRO_TUNE_CACHE"] = TUNE_CACHE
    tune_cache.clear_memo()
    counts_now = lambda: {k: w.launches for k, w in wrappers.items()}
    g, _, _ = workloads.build_particle_graph(PARTICLE_N, block=None)
    fields = workloads.particle_fields(PARTICLE_N)
    inputs = {
        k: RecordArray.from_fields(spec, {f: torch.from_numpy(v).to(dev)
                                          for f, v in fields[k].items()},
                                   lay)
        for k, (spec, lay) in specs.items()}
    del fields
    run = tune_graph("particle_step", g, inputs,
                     {"ions": TOL["float32"], "electrons": TOL["float32"],
                      "field": TOL["float32"], "vmax": 0.0},
                     card, zero_counts, counts_now)
    path_launches["tune particle_step"] = run["counts"]
    expect["tune particle_step"] = {
        k: 2 * n * run["captures"]
        for k, n in REGION_KERNELS["particle_step"].items()}
    del inputs, run
    g, _ = workloads.build_flux_graph(FLUX_N, FLUX_N, lam_x=FLUX_LAM,
                                      lam_y=FLUX_LAM)
    run = tune_graph("flux", g, {"u": u0},
                     {"u": 0.0, "flux": FLUX_TOL["float32"]},
                     card, zero_counts, counts_now)
    path_launches["tune flux"] = run["counts"]
    expect["tune flux"] = {"flux_difference": 2 * run["captures"]}
    del u0, g, run
    gc.collect()
    torch.cuda.empty_cache()
    for path in ("tune particle_step", "tune flux"):
        counts = path_launches[path]
        log(f"main path launches {path}: {json.dumps(counts)}")
        for k, n in counts.items():
            if n != expect[path].get(k, 0):
                raise AssertionError(f"{k}: {n} launches in {path}, "
                                     f"expected {expect[path].get(k, 0)}")
            launches[k] += n

    # LM serving: qwen3-8b through K6, mamba2-130m through K7, gemma3-12b
    # and recurrentgemma-9b through K6 at head dim 256 with a window
    # 3g: qwen1.5-4b and chatglm3-6b through the Batcher, then
    # seamless-m4t-medium and llava-next-mistral-7b through the uniform
    # loop (the encoder, cross-attention and patches through K6)
    # 3h: phi3.5-moe and arctic-480b, cut in depth, through the Batcher
    lm_runs = {}
    for arch in (("qwen3-8b", "mamba2-130m") + LM_LOCAL_ARCHS
                 + LM_DENSE_ARCHS + LM_FRONTEND_ARCHS + LM_MOE_ARCHS):
        serve = serve_frontend if arch in LM_FRONTEND_ARCHS else serve_lm
        t_arch = time.perf_counter()
        run = serve(arch, card, zero_counts,
                    lambda: {k: w.launches for k, w in wrappers.items()})
        log(f"serve {arch}: {time.perf_counter() - t_arch:.1f} s")
        lm_runs[arch] = run
        gc.collect()     # the model went with the serving function's frame
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        path_launches[f"serve {arch}"] = run["counts"]
        expect[f"serve {arch}"] = {k: n for k, n in run["expect"].items()
                                   if n}
    for path, counts in path_launches.items():
        if not path.startswith("serve"):
            continue
        log(f"main path launches {path}: {json.dumps(counts)}")
        for k, n in counts.items():
            if n != expect[path].get(k, 0):
                raise AssertionError(f"{k}: {n} launches in {path}, "
                                     f"expected {expect[path].get(k, 0)}")
            launches[k] += n

    # -- 3b. outputs in place, and region compile: the same graphs and
    # serving, regions=True ----------------------------------------------
    def peak(phase):
        gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"phase {phase} peak {gib:.2f} GiB allocated; it ended "
            f"{time.perf_counter() - t_script:.1f} s into the script "
            f"({card})")
        torch.cuda.reset_peak_memory_stats()

    peak("3")
    out_checks(card, eik_mid, eik["mask"])
    reg = regions_phase(card, zero_counts, counts_now)
    lm_reg = {arch: serve_regions(arch, card, zero_counts, counts_now)
              for arch in ("qwen3-8b", "mamba2-130m")}
    peak("3b")

    # -- 3c. async regions over the particle step with a host diagnostic --
    asy = async_phase(card, zero_counts, counts_now)
    peak("3c")

    # -- 3d. a mesh of four shards on the card: flux, eikonal, Euler ------
    msh = mesh_phase(card, zero_counts, counts_now, eik)
    for k, n in msh["launches"].items():
        launches[k] += n
    peak("3d")

    # -- 3e. measured tuning on a mesh, and the paper's examples ----------
    exa = examples_phase(card, zero_counts, counts_now)
    for k, n in exa["launches"].items():
        launches[k] += n
    peak("3e")

    # -- 3f. training: the ten archs, the gradient gates, the supervisor --
    trn = train_phase(card, zero_counts, counts_now)
    for k, n in trn["launches"].items():
        launches[k] += n
    peak("3f")

    # -- 3i. explicit collectives: the MoE all-to-all, phi3.5-moe's prefill
    # through the hook, sequence parallelism, compressed_psum ------------
    par = parallel_phase(card, zero_counts, counts_now)
    for k, n in par["launches"].items():
        launches[k] += n
    peak("3i")

    # -- 4. times -----------------------------------------------------------
    results = {}
    x, y = randn(SAXPY_N), randn(SAXPY_N)
    n = SAXPY_N
    nbc_ms = time_ms(lambda: saxpy_cuda(SAXPY_A, x, y, bounds_check=False))
    results["saxpy"] = dict(
        ms=time_ms(lambda: saxpy_cuda(SAXPY_A, x, y)),
        plain_ms=time_ms(lambda: saxpy_ref(SAXPY_A, x, y)),
        library_ms=time_ms(lambda: torch.add(y, x, alpha=SAXPY_A)),
        nbytes=3 * n * 4, ops=2 * n)
    log(f"time saxpy NBC: {nbc_ms:.4f} ms ({card})")
    log(f"host time per call: saxpy "
        f"{host_us(lambda: saxpy_cuda(SAXPY_A, x, y)):.1f} us, torch.add "
        f"{host_us(lambda: torch.add(y, x, alpha=SAXPY_A)):.1f} us ({card})")
    del x, y

    rec = RecordArray(randn(2, PARTICLE_N), SAXPY_SPEC, Layout.SOA)
    results["saxpy_record"] = dict(
        ms=time_ms(lambda: saxpy_record_cuda(rec, workloads.DT)),
        plain_ms=time_ms(lambda: saxpy_record_ref(rec, workloads.DT)),
        library_ms=None, nbytes=2 * 2 * PARTICLE_N * 4, ops=2 * PARTICLE_N)
    del rec

    recs = {lay: RecordArray(randn(6, PARTICLE_N), PARTICLE_SPEC,
                             Layout.SOA).with_layout(lay)
            for lay in (Layout.AOS, Layout.AOSOA)}
    aos = recs[Layout.AOS]
    results["particle_update"] = dict(
        ms=time_ms(lambda: particle_update_cuda(aos, workloads.DT)),
        plain_ms=time_ms(lambda: particle_update_ref(aos, workloads.DT)),
        library_ms=None, nbytes=2 * 6 * PARTICLE_N * 4, ops=6 * PARTICLE_N)
    aosoa = recs[Layout.AOSOA]
    log(f"time particle_update AOSOA: "
        f"{time_ms(lambda: particle_update_cuda(aosoa, workloads.DT)):.4f} "
        f"ms, plain "
        f"{time_ms(lambda: particle_update_ref(aosoa, workloads.DT)):.4f} "
        f"ms ({card})")
    del recs, aos, aosoa

    u = haloed_shock_bubble(torch.float32)
    rec = RecordArray(u, EULER_SPEC, Layout.SOA)
    nx = ny = FLUX_N
    faces = (nx + 1) * ny + nx * (ny + 1)
    results["flux_difference"] = dict(
        ms=time_ms(lambda: flux_difference_cuda(rec, FLUX_LAM, FLUX_LAM)),
        plain_ms=time_ms(lambda: flux_difference_ref(rec, FLUX_LAM,
                                                     FLUX_LAM), iters=20),
        library_ms=None,
        nbytes=4 * 4 * ((nx + 2) * (ny + 2) + nx * ny),
        ops=faces * OPS_PER_FACE + nx * ny * OPS_PER_CELL)
    # K4 in its other layout and storage type, and its traffic alone: the
    # same loads, shuffles and stores with a sum for the flux arithmetic
    aos = relayout(rec, Layout.AOS)
    rec_bf16 = RecordArray(u.bfloat16(), EULER_SPEC, Layout.SOA)
    for what, fn in (
            ("AOS", lambda: flux_difference_cuda(aos, FLUX_LAM, FLUX_LAM)),
            ("SOA bfloat16", lambda: flux_difference_cuda(
                rec_bf16, FLUX_LAM, FLUX_LAM)),
            ("SOA (loads, shuffles and stores alone)",
             lambda: flux_traffic_cuda(rec)),
            ("AOS (loads, shuffles and stores alone)",
             lambda: flux_traffic_cuda(aos))):
        log(f"time flux_difference {what}: {time_ms(fn):.4f} ms ({card})")
    del rec, u, aos, rec_bf16

    nx = ny = EIK_N
    phi = eik_mid
    results["eikonal_fim"] = dict(
        ms=time_ms(lambda: eikonal_fim_cuda(phi, eik["mask"], 1 / EIK_N,
                                            inner=EIK_INNER,
                                            block=EIK_BLOCK)),
        plain_ms=time_ms(lambda: eikonal_fim_ref(phi, eik["mask"],
                                                 1 / EIK_N, inner=EIK_INNER,
                                                 block=EIK_BLOCK), iters=10),
        library_ms=None,
        nbytes=4 * (nx + 2) * (ny + 2) + nx * ny + 4 * nx * ny,
        ops=EIK_OPS_PER_CELL_SWEEP * EIK_INNER * nx * ny)
    # K5 at the other timed tiles and in bfloat16, and two variants of the
    # main path's call: inner 0 (the loads and stores alone), and phi and
    # the mask one element off their allocations, which turns off every
    # vector access (pair loads, mask words, float4 stores)
    off_phi = torch.empty(phi.numel() + 1, device=dev)[1:].view(phi.shape)
    off_phi.copy_(phi)
    mask = eik["mask"]
    off_mask = torch.empty(mask.numel() + 1, dtype=mask.dtype,
                           device=dev)[1:].view(mask.shape)
    off_mask.copy_(mask)
    for what, args, m, inner, tile in (
            ("", phi, mask, 1, EIK_BLOCK),
            ("", phi, mask, EIK_INNER, (64, 256)),
            (" bfloat16", phi.bfloat16(), mask, EIK_INNER, EIK_BLOCK),
            (" (loads and stores alone)", phi, mask, 0, EIK_BLOCK),
            (" (scalar accesses: phi and mask off the grid)", off_phi,
             off_mask, EIK_INNER, EIK_BLOCK),
            (" (scalar accesses: phi and mask off the grid)", off_phi,
             off_mask, EIK_INNER, (64, 256))):
        ms = time_ms(lambda: eikonal_fim_cuda(args, m, 1 / EIK_N,
                                              inner=inner, block=tile))
        log(f"time eikonal_fim inner={inner} tile={tile}{what}: {ms:.4f} ms "
            f"({card})")
    host = host_us(lambda: eikonal_fim_cuda(phi, eik["mask"], 1 / EIK_N,
                                            inner=EIK_INNER,
                                            block=EIK_BLOCK))
    log(f"host time per call: eikonal_fim {host:.1f} us ({card})")
    del phi, off_phi, mask, off_mask, eik, eik_mid

    for dname in ("bfloat16", "float32"):
        q, k, v = attn_inputs(getattr(torch, dname))
        B, Hq, Hkv, S, D = ATTN_SHAPE
        nbytes, ops = attn_work(B, Hq, Hkv, S, S, D, q.element_size())
        r = dict(
            ms=time_ms(lambda: flash_attention_cuda(q, k, v)),
            plain_ms=time_ms(lambda: mha_ref(q, k, v), iters=10),
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)),
            nbytes=nbytes, ops=ops,
            ops_per_s=BF16_TC_OPS_PER_S if dname == "bfloat16"
            else F32_OPS_PER_S)
        if dname == "bfloat16":
            results["flash_attention"] = r
        else:
            log(f"time flash_attention float32: kernel {r['ms']:.4f} ms, "
                f"bound {bound(nbytes, ops)[0]:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
                f"({card})")
        del q, k, v
    # the NaN-ignoring max at the benchmark's views, its bound the bytes of
    # the view's span; torch.amax (which propagates NaN) as the yardstick
    out0 = torch.empty((), device=dev)
    for what, make in (
            ("the ions' AoS v", lambda: randn(REDUCE_IONS_N, 6)[:, 3:6]),
            ("the eikonal change", lambda: randn(REDUCE_GRID_N,
                                                 REDUCE_GRID_N))):
        view = make()
        r = dict(
            ms=time_ms(lambda: nan_ignoring_extremum_cuda(
                view, largest=True, out=out0)),
            plain_ms=time_ms(lambda: nan_ignoring_extremum_ref(
                view, largest=True, out=out0), iters=10),
            library_ms=time_ms(lambda: torch.amax(view)),
            nbytes=span_bytes(view), ops=view.numel())
        log(f"time nan_ignoring_extremum {what} {tuple(view.shape)} "
            f"strides {view.stride()}: kernel {r['ms']:.4f} ms, bound "
            f"{bound(r['nbytes'], r['ops'])[0]:.4f} ms ({r['nbytes']} bytes "
            f"of span), torch route {r['plain_ms']:.4f} ms, torch.amax "
            f"{r['library_ms']:.4f} ms ({card})")
        results.setdefault("nan_ignoring_extremum", r)
        del view
        torch.cuda.empty_cache()
    local_attention_times(card)
    serving_attention_times(card)
    x, dts, A, Bm, C = ssd_inputs(torch.bfloat16)
    nbytes, ops = ssd_work(*SSD_SHAPE, x.element_size())
    chunk = SSD_SHAPE[-1]
    results["ssd_intra_chunk"] = dict(
        ms=time_ms(lambda: ssd_intra_chunk_cuda(x, dts, A, Bm, C,
                                                chunk=chunk)),
        plain_ms=time_ms(lambda: ssd_intra_chunk_ref(x, dts, A, Bm, C,
                                                     chunk=chunk)),
        library_ms=None, nbytes=nbytes, ops=ops,
        ops_per_s=BF16_TC_OPS_PER_S)
    # the kernel's device time apart from its wrapper's host time: 30
    # launches under the profiler, and the host time of one call
    k7 = {name: v for name, v in device_time_by_kernel(
        lambda: [ssd_intra_chunk_cuda(x, dts, A, Bm, C, chunk=chunk)
                 for _ in range(30)]).items() if "ssd" in name}
    k7_host = host_us(lambda: ssd_intra_chunk_cuda(x, dts, A, Bm, C,
                                                   chunk=chunk))
    for name, (us, count) in k7.items():
        log(f"time ssd_intra_chunk bf16 device (profiler): "
            f"{us / count / 1e3:.4f} ms per launch over {count} launches "
            f"of {name[:60]}; host time per call {k7_host:.1f} us; "
            f"time_ms {results['ssd_intra_chunk']['ms']:.4f} ms ({card})")
    if not k7:
        log("time ssd_intra_chunk bf16 device (profiler): not measured (the "
            "profiler saw no device activity)")
    # ... and at the tile registry's chunk of 256 (two 128-row tiles a
    # block), beside chunk 128's above
    k7 = {name: v for name, v in device_time_by_kernel(
        lambda: [ssd_intra_chunk_cuda(x, dts, A, Bm, C, chunk=SSD_CHUNK_256)
                 for _ in range(30)]).items() if "ssd" in name}
    b256 = bound(*ssd_work(*SSD_SHAPE[:-1], SSD_CHUNK_256, 2),
                 BF16_TC_OPS_PER_S)[0]
    for name, (us, count) in k7.items():
        log(f"time ssd_intra_chunk bf16 chunk {SSD_CHUNK_256} device "
            f"(profiler): {us / count / 1e3:.4f} ms per launch over {count} "
            f"launches of {name[:60]}; bound {b256:.4f} ms ({card})")
    if not k7:
        log(f"time ssd_intra_chunk bf16 chunk {SSD_CHUNK_256} device "
            f"(profiler): not measured (the profiler saw no device "
            f"activity)")
    x, dts, A, Bm, C = ssd_inputs(torch.float32)
    f32_ms = time_ms(lambda: ssd_intra_chunk_cuda(x, dts, A, Bm, C,
                                                  chunk=chunk))
    log(f"time ssd_intra_chunk float32: kernel {f32_ms:.4f} ms, bound "
        f"{bound(*ssd_work(*SSD_SHAPE, 4))[0]:.4f} ms ({card})")
    f32_ms = time_ms(lambda: ssd_intra_chunk_cuda(x, dts, A, Bm, C,
                                                  chunk=SSD_CHUNK_256))
    log(f"time ssd_intra_chunk float32 chunk {SSD_CHUNK_256}: kernel "
        f"{f32_ms:.4f} ms ({card})")
    del x, dts, A, Bm, C
    for arch, run in lm_runs.items():
        if arch in LM_FRONTEND_ARCHS:
            enc = run["encoder_ms"]
            log(f"serve {arch} through the uniform loop ({FRONTEND_ROWS} "
                f"rows of {FRONTEND_PROMPT} tokens, {LM_GEN} new each): "
                f"prefill {run['row_prefill_ms']:.3f} ms a row in the loop, "
                f"{run['prefill_ms']:.3f} alone"
                f"{f' (the encoder {enc:.3f})' if enc else ''}; decode "
                f"{run['step_ms']:.3f} ms per step; {run['tok_s']:.1f} "
                f"tokens/s end to end, {run['decode_tok_s']:.1f} decoding; "
                f"prefill logits {run['logit_err']:.4e} (wrong variant "
                f"{run['wrong_err']:.4e}); decode check "
                f"{run['decode']['err']:.4e} (wrong variants "
                f"{json.dumps(run['decode']['wrong'])}) ({card})")
            continue
        if arch in LM_MOE_ARCHS:
            b1 = run["batch1"]
            pre = run["busy"]["prefill"]
            log(f"serve {arch} ({MOE_LAYERS[arch]} layers) at the defaults: "
                f"{run['tok_s']:.1f} tokens/s with the decode capture, "
                f"{run['warm_tok_s']:.1f} without; decode "
                f"{run['step_ms']:.3f} ms per step (4 slots), batch 1 "
                f"{b1['step_ms']:.3f}, bound {b1['bound_ms']:.3f} (every "
                f"weight read once); eager prefill ms per request "
                f"{[round(ms, 3) for _, ms in run['prefill_ms']]}; batch 1 "
                f"prefill {pre[0]:.3f} ms ({100 * pre[1] / pre[0]:.1f} % "
                f"busy), {b1['tok_s']:.1f} tokens/s; pairs dropped per "
                f"prefill {[sum(r) for r in run['drops']]}; prefill logits "
                f"{run['logit_err']:.4e} replayed, {run['free_err']:.4e} "
                f"free ({run['differ']} choices differ); wrong variants "
                f"{json.dumps(run['wrong'])} ({card})")
            continue
        if arch in LM_LOCAL_ARCHS + LM_DENSE_ARCHS:
            b1 = run["batch1"]
            ring = run["ring"]
            pre = run["busy"]["prefill"]
            log(f"serve {arch} at the defaults: {run['tok_s']:.1f} tokens/s "
                f"with the decode capture, {run['warm_tok_s']:.1f} without; "
                f"decode {run['step_ms']:.3f} ms per step (4 slots); eager "
                f"prefill ms per request "
                f"{[round(ms, 3) for _, ms in run['prefill_ms']]}; batch 1: "
                f"{b1['tok_s']:.1f} tokens/s, decode {b1['step_ms']:.3f} ms "
                f"per step (bound {b1['bound_ms']:.3f}), prefill "
                f"{pre[0]:.3f} ms ({100 * pre[1] / pre[0]:.1f} % busy); "
                f"prefill logits {run['logit_err']:.4e} (wrong variant "
                f"{run['wrong_err']:.4e}); "
                + (f"ring {ring['err']:.4e} (no wrap "
                   f"{ring['wrong_err']:.4e}) " if ring else "")
                + f"({card})")
            continue
        caps = {n: [round(c["first_ms"], 1), round(c["peak_gib"], 3),
                    round(c["kept_gib"], 3)]
                for n, c in run["captures"].items()}
        inter = run["interleaved"]
        log(f"serve {arch} at the defaults: {run['tok_s']:.1f} tokens/s "
            f"with the decode capture, {run['warm_tok_s']:.1f} without; "
            f"decode {run['step_ms']:.3f} ms per step, eager prefill ms "
            f"per request {[round(ms, 3) for _, ms in run['prefill_ms']]}; "
            f"ragged (8 new lengths) eager prefills "
            f"{run['ragged']['eager']:.1f} tokens/s, captured "
            f"{run['ragged']['captured']:.1f}; repeated lengths on captured "
            f"replays {run['captured_tok_s']:.1f}; prefill captures by "
            f"length (first call ms, peak GiB, kept GiB) {json.dumps(caps)};"
            f" two batchers in turn {inter['turn_ms']:.3f} ms a step and "
            f"{inter['moved_per_step']:.0f} bytes moved out a step, alone "
            f"{inter['alone_ms']:.3f} ms ({card})")
    t = exa["tune"]
    log(f"tune mesh flux (2, 2) at the defaults: search {t['search_s']:.3f} "
        f"s, {t['measured']} of {t['proposed']} candidates measured, "
        f"{t['captures']} captures; {' '.join(t['winner'])}; ms per step "
        f"heuristic {t['base_ms']:.3f}, tuned {t['tuned_ms']:.3f} ({card})")
    for name, row in reg.items():
        log(f"regions {name}: ms per "
            f"{'iteration' if name == 'eikonal_solve' else 'step'} eager "
            f"{row['eager_ms']:.3f}, regions donate=False "
            f"{row['donate=False']['ms']:.3f}, donate=True "
            f"{row['donate=True']['ms']:.3f}; device busy eager "
            f"{row['eager_busy_ms']:.4f} ms, regions "
            f"{row['donate=True']['busy_ms']:.4f} ms ({card})")
    log(f"async particle_step_diagnostic: ms per step "
        f"{json.dumps({k: round(v, 4) for k, v in asy['times'].items()})}, "
        f"sync/async with the host time {asy['gain']:.2f}x ({card})")
    def by_donate(rows, key):
        return {d: round(v[key], 4) for d, v in rows.items()}

    flux_r = {k: by_donate(r["regions"], "ms")
              for k, r in msh["flux"].items()}
    euler_r = {k: {t: by_donate(r, "ms") for t, r in e.items()}
               for k, e in msh["euler"].items() if "regions" in k}
    euler_e = {k: e for k, e in msh["euler"].items() if "regions" not in k}
    log(f"mesh regions (ms per step; eikonal s; by donate): flux "
        f"{json.dumps(flux_r)}, eikonal "
        f"{json.dumps(by_donate(msh['eikonal']['regions'], 's'))}, euler "
        f"{json.dumps(euler_r)} ({card})")
    log(f"mesh flux ms per step: "
        f"{json.dumps({k: round(r['ms'], 4) for k, r in msh['flux'].items()})}"
        f", halo bytes a step "
        f"{json.dumps({k: r['copied'] for k, r in msh['flux'].items()})}; "
        f"eikonal solve s: mesh {msh['eikonal']['mesh_s']:.3f}, unsharded "
        f"{msh['eikonal']['unsharded_s']:.3f}; euler ms per step "
        f"{json.dumps(euler_e)} ({card})")
    for arch, runs in lm_reg.items():
        log(f"regions serve {arch}: tokens/s eager "
            f"{runs['eager']['tok_s']:.1f}, regions "
            f"{runs['regions']['tok_s']:.1f}; decode ms per step eager "
            f"{runs['eager']['step_ms']:.3f}, regions "
            f"{runs['regions']['step_ms']:.3f} ({card})")
    tq, tm = trn["qwen"], trn["mamba"]
    log(f"train qwen3-8b ({TRAIN_QWEN_LAYERS} layers, {TRAIN_QWEN_BATCH} x "
        f"{TRAIN_SEQ}): {tq['step_ms']:.1f} ms a step, {tq['tok_s']:.0f} "
        f"tokens/s, peak {tq['peak_gib']:.2f} GiB, {100 * tq['mfu']:.1f} % "
        f"of 989 TFLOP/s; K6 forward {tq['k6_alone']['A']['fwd_ms']:.4f} "
        f"ms, its plain recompute backward "
        f"{tq['k6_alone']['A']['bwd_ms']:.4f} ms alone, "
        f"{tq['bwd_step_ms']:.3f} ms a step; gradient gate max "
        f"relative L2 {trn['gate']['qwen3-8b']['max_rel']:.3e}; train "
        f"mamba2-130m ({TRAIN_MAMBA_BATCH} x {TRAIN_SEQ}): "
        f"{tm['step_ms']:.1f} ms a step, checkpoint {tm['gb']:.3f} GB "
        f"written in {tm['write_ms']:.1f} ms, recovery "
        f"{tm['recovery_ms']:.1f} ms; gradient gate max relative L2 "
        f"{trn['gate']['mamba2-130m']['max_rel']:.3e} ({card})")

    for arch, r in trn["archs"].items():
        shapes = "; ".join(
            f"{label} {t['fwd_ms']:.4f} / {t['bwd_ms']:.4f}"
            for label, t in r["k6_alone"].items())
        scan = r.get("scan")
        log(f"train {arch} ({train_config(arch).n_layers} layers, "
            f"{TRAIN_ARCH_CASES[arch][1]} x {TRAIN_SEQ}): {r['step_ms']:.1f} ms a "
            f"step, {r['tok_s']:.0f} tokens/s, peak {r['peak_gib']:.2f} GiB "
            f"(reckoned {r['reckoned']['step'] / 2**30:.2f}), "
            f"{100 * r['mfu']:.1f} % of 989 TFLOP/s; profiled step device "
            f"{r['step_us'] / 1e3:.2f} ms, K6 {r['k6_us'] / 1e3:.3f}, its "
            f"backward {r['bwd_step_ms']:.3f}; K6 alone forward / "
            f"backward ms: {shapes}; gradient gate max relative L2 "
            f"{r['gate']['max_rel']:.3e} (detached "
            f"{r['gate']['detached_max']:.3e})"
            + (f"; RG-LRU scan launches forward {scan['forward']['launches']}"
               f", backward {scan['backward']['launches']}" if scan else "")
            + f" ({card})")
    log(f"layer gradients, card against CPU (float32): "
        + "; ".join(f"{k} {v['max_rel']:.3e}"
                    for k, v in trn["layers"].items())
        + f" (limit {LAYER_GRAD_TOL:g}); phase 3f {trn['secs']:.1f} s "
        f"({card})")
    tmo = trn["moe"]
    log(f"train phi3.5-moe ({TRAIN_MOE_LAYERS} layers, {TRAIN_MOE_BATCH} x "
        f"{TRAIN_SEQ}, deterministic): "
        + "; ".join(f"{mode} {r['step_ms']:.1f} ms a step, peak "
                    f"{r['peak_gib']:.2f} GiB" for mode, r in tmo.items())
        + f"; gradient gate max relative L2 "
        f"{trn['gate']['phi3.5-moe']['max_rel']:.3e} ({card})")
    for arch in ("phi", "arctic"):
        a = par[arch]
        log(f"a2a {arch}: worst forward max |difference| "
            f"{max(a['cases'].values()):.4e} over {len(a['cases'])} cases, "
            f"wrong variant {a['wrong']:.4e}; ms a2a {a['a2a_ms']:.3f}, "
            f"moe_block {a['block_ms']:.3f}, per shard {a['shard_ms']:.3f}; "
            f"{a['moved']} bytes an all_to_all ({card})")
    h = par["hook"]
    log(f"phase 3i: phi3.5-moe prefill through the hook logits "
        f"{h['err']:.4e} (free {h['free_err']:.4e}, {h['differ']} choices "
        f"differ; wrong {h['wrong']:.4e}), {h['hook_ms']:.3f} ms against "
        f"{h['rows_ms']:.3f} for the rows alone; seqpar carry "
        f"{par['seqpar']['carry_err']:.4e}; compressed_psum mean "
        f"{par['cpsum']['err']:.4e}, {par['cpsum']['call_ms']:.3f} ms a "
        f"call; {par['secs']:.1f} s ({card})")

    entries = []
    for name, meta in kernels.items():
        r = results[name]
        b_ms, b_by = bound(r["nbytes"], r["ops"],
                           r.get("ops_per_s", F32_OPS_PER_S))
        lib_ms = r["library_ms"]
        lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"time {name}: kernel {r['ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {r['nbytes']} bytes, {r['ops']} ops), plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ({card})")
        entries.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"]})

    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s ({card})")
    log(f"card: {card}")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
