#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --serve-once DIR   # phase 11's cold or warm start alone
    python3 chip_smoke.py --dist-rank R DIR  # one rank of phase 14 (phase 14 starts them)
    python3 chip_smoke.py --mesh-rank DIR    # phase 9h alone (the main run starts it)

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``); no CUDA device -> exit 2;
2. build the Hopper kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source, all started together (the ``-Xptxas -v`` reports
   are printed);
3. ``mttkrp3`` at 1000x1000x1000, R=64 (extents not multiples of the tiles),
   fp32 and bf16, all three modes through ``kernels.ops``, each against its
   plain version on the card; the 3-way generic variant (``mttkrpn``) too;
   ``splitk_reduce`` on that shape's workspace, timed by CUDA graphs
   (``graph_ms``: a few microseconds, below the host's launch rate);
4. ``mttkrpn`` at 180^4, R=32, fp32, all four modes, and ``splitk_reduce``
   on that shape's workspace (132 slabs of 5,760 outputs);
5. the fused-sweep kernels against their plain versions, in every position
   the sweeps use them: ``fused_pair`` at 1000^3, R=64 (fp32, bf16) and
   180^4, R=32, each record with its ``MTTKRPKernelPlan``, shared memory,
   split count and registers, its bound counted as the tensor cores run its
   products (``mma_bound``); ``mttkrp_partial`` with one contraction axis on 1000^3's
   rank-augmented nodes and with two on 180^4's P (fp32 and bf16), each
   node read in place as ``contract_partial`` hands it over (the permuted
   view) and as its canonical copy, each record with its
   ``PartialKernelPlan``, shared memory and registers, timed as device time
   by CUDA graphs (``graph_ms``: kernel, plain version, ``torch.einsum``)
   with the back-to-back call rate beside (``host_ms``) and the copy the
   engine no longer makes (``transpose_ms``); ``mttkrpn`` on the
   dimension tree's 2-D edge at 1000^3; at 180^4 the 4-way tree's two root
   edges (``mttkrp3`` on X as (32400, 180, 180), once after a permute) and
   the k=1 partials on both leaves of each (180, 180, R) node;
6. the main paths: CP-ALS (``backend="cuda"``) on a 1000^3 tensor of CP
   rank 64 plus noise (10 iterations) and on a 180^4 tensor of CP rank 32
   plus noise (5 iterations), with each schedule (``per_mode``, ``fused``,
   ``dimtree``), each timed after one untimed iteration; every kernel's
   launch count is set to 0 before each run and read after, and must equal
   the schedule's launches per iteration times the iterations run (the
   untimed one included); every node ``contract_partial`` hands the
   partial kernel must arrive as a view of the node (no copy), rank axis at
   unit stride; each run is held against the same schedule with
   ``backend="einsum"`` and against the cuda ``per_mode`` run, from the
   same initial factors: fits within 1e-4 at every iteration;
   6b. CP-ALS on a 10000 x 10000 matrix of CP rank 64 plus noise (5
   iterations, ``per_mode``): exactly two ``mttkrpn`` launches an iteration
   (one contraction axis each) and no other counted kernel; fits within 1e-4
   of einsum's;
7. ``multi_ttm_keep`` against its plain version on every kept mode (the
   kept mode brought first as ``multi_ttm`` does) and on the full core
   (``keep=None``, through ``repro_torch.multi_ttm``): 1000^3 with ranks
   (32, 32, 32) in fp32 and bf16 inputs, 180^4 with ranks (16, 16, 16, 16)
   in fp32, each record with its ``MultiTTMKernelPlan``, shared memory,
   split count and registers, its bound counted as the tensor cores run the
   mode-by-mode operations (``mma_bound``);
8. the Tucker path: ``tucker_hooi`` from HOSVD factors on a 1000^3 tensor
   of multilinear rank (32, 32, 32) and a 180^4 tensor of multilinear rank
   (16, 16, 16, 16), each plus 10 % noise: 5 sweeps on ``backend="cuda"``
   and on ``backend="einsum"``, each after one untimed sweep, counts set to
   0 before and read after (exactly N ``multi_ttm_keep`` launches a sweep,
   and one split-K reduction for each mode whose grid splits); fits
   finite, within 1e-4 of einsum's at every sweep (``FIT_NOISE``) and, on
   both backends, never more than 3e-5 below the sweep before
   (``FIT_DROP``: fp32 rounding); factors orthonormal within 1e-4; for
   each mode the smallest singular value of ``A_cuda^T A_einsum`` at least
   0.9999; one ``n_iters=0`` call, which
   makes exactly one launch; then the same trajectory one sweep a call,
   with float64 readings: ``||X||^2``, each core's fit from float64 sums,
   and the fit of the factors' subspaces (QR in float64, X projected in
   float64), which must not fall by more than 1e-9 from the HOSVD subspace
   through every sweep and must agree within 1e-9 between the backends;
9. the Mamba2 path: (a) ``ssd_intra`` against its plain version at the
   served shape (BC = 64 chunks of q = 256, N = 128, H = 80, P = 64), x in
   bf16 with the rest fp32 (the model's mix, within 1e-2) and all fp32
   (within 1e-5), timed beside its bound; in bf16 also on operands where
   weights rounded to bf16 once show (``ssd_cancelling``: within ``LO_TOL``
   1e-2, where that control reads above it); (b) ``mamba2-2.7b`` at full
   width and depth (64 layers, bf16, weights drawn on the card): prefill of 4
   prompts x 4096 tokens (``forward(mode="prefill", logits_positions=
   "last")``), timed after one untimed call, counts set to 0 before and read
   after (exactly 64 ``ssd_intra`` launches, nothing else), finite logits;
   then 32 greedy ``decode_step``s a prompt, timed per token (no kernel
   launch); (c) the same model in fp32: prefill logits at every position of
   one 512-token prompt (two chunks) against token-by-token ``decode_step``
   logits, max |d| / max |prefill| within ``DUAL_TOL``; (d) the dense
   decoders (``DENSE_LAYERS``: ``qwen2-1.5b`` at full depth,
   ``deepseek-coder-33b``, ``yi-34b`` and ``nemotron-4-340b`` cut to 2
   layers), each at full width in bf16 with weights drawn on the card:
   prefill of 2 prompts x 1024 tokens (``DENSE_PREFILL``; ``mode=
   "prefill"``, ``logits_positions="last"``), timed after one untimed
   call, counts set to 0 before and read after (no kernel launched),
   finite logits of shape (2, 1, V), the peak memory; then 32 greedy
   ``decode_step``s a prompt from ``init_decode_state(max_len=1024)``,
   timed per token, no kernel launched; each model freed before the next;
   then ``qwen2-1.5b`` in fp32 at full width and 4 layers (``DENSE_DUAL``)
   on one 2048-token prompt (``flash_attention`` runs 2 x 2 blocks of 1024,
   one fully masked): prefill logits at every position and token-by-token
   ``decode_step`` logits for the first 256 positions, each against the
   ``mode="train"`` logits, max |d| / max |train| over the real vocabulary
   within ``DUAL_TOL``. The phase prints its times and asserts none;
   (e) the MoE models and the hybrid (``MOE_LAYERS``: ``olmoe-1b-7b`` and
   ``granite-moe-3b-a800m`` at full depth, ``jamba-v0.1-52b`` cut to one
   period of 8 layers), served as in (d): exactly one ``ssd_intra`` launch
   for each of jamba's 7 SSM layers a prefill, none a decode step, none for
   the other two; finite (2, 1, V) logits; the choices capacity dropped in
   the untimed prefill and the router's smallest margin printed; then the
   MoE layer of each config at full width in fp32 on ``MOE_TOKENS`` tokens
   with its routing held fixed (``apply_moe(routing=)``) against a plain
   loop over the experts that takes the same gates, experts and kept
   choices, within ``MOE_TOL`` of max |plain|, once as routed and once
   with the router skewed towards expert 0 until its queue overflows (each
   expert keeps exactly min(count, cap) choices, the earliest in
   token-major order); then ``ssd_intra`` at jamba's shape
   (``JAMBA_SSD``) against its plain version (x bf16 within 1e-2, fp32
   within 1e-5). No check compares two paths through a router; times are
   printed, none asserted;
   (f) the VLM backbone and the encoder-decoder model, from a generator of
   their own: ``qwen2-vl-72b`` at full width cut to ``VLM_LAYERS`` (4),
   served as in (d) but prefilled from (2, 1024, 8192) patch embeddings
   (its stub frontend's input); ``whisper-tiny`` at full width and depth:
   the encoder on (2, ``WHISPER_FRAMES``) frame embeddings, Whisper's 30 s
   window, unmasked in ``train`` mode (the recipe of the reference's
   ``tests/test_archs.py``; 1500 frames cannot go through ``flash_attention``),
   then ``enc_norm`` and ``_encoder_kv``; one teacher-forced
   ``forward`` on the frames and (2, 448) decoder tokens; 32 greedy
   ``decode_step``s with that ``cross_kv`` from ``WHISPER_START`` on
   ``init_decode_state(max_len=448)``; no kernel launched, finite logits;
   then the whisper duality in fp32: ``forward(mode="train")`` on 1500
   frames and ``WHISPER_DUAL_TOKENS`` decoder tokens against
   token-by-token ``decode_step(cross_kv=)`` over the same positions,
   within ``DUAL_TOL``. Times printed, none asserted;
   (g) the training path, from a generator of its own: ``SsdIntra``'s five
   gradients at ``TRAIN_SSD`` (BC = 16, q = 256, N = 128, H = 80, P = 64)
   against autograd through ``ssd_intra_plain`` (``SSD_GRAD_TOL``: 1e-5
   fp32, 1e-2 with x in bf16), one launch for forward and backward, the
   backward's device time beside the plain version's; ``mamba2-2.7b`` in
   fp32 at full width cut to 2 layers on 2 x 512 tokens: ``loss_fn``'s
   loss and every gradient against the same model with ``ssd_intra``
   swapped for its plain version (within ``TRAIN_GRAD_TOL`` 1e-4 of each
   leaf's largest gradient), remat ``none``/``full``/``dots`` within
   ``REMAT_TOL`` 1e-6 (bit-equality printed), exactly 2 / 4 / 4
   ``ssd_intra`` launches a step, and 5 AdamW steps on the fixed batch
   with a falling loss; ``mamba2-2.7b`` in bf16 at full width and depth
   (2.70 G parameters, weights drawn on the card): ``init_train_state``
   and ``build_train_step`` on a fixed 2 x 2048-token ``synthetic_batch``,
   one untimed step and 3 timed, exactly 128 ``ssd_intra`` launches a
   step and no other counted kernel, finite loss and gradient norm, ms a
   step, tokens/s and peak memory printed; ``python -m
   repro_torch.launch.train`` on the smoke model in a subprocess (exit 0,
   its two lines, ``step_15`` and ``step_20`` kept), then ``TrainLoop``
   on the smoke model with a failure injected at step 6 (one restart, step
   10, final parameters within ``LOOP_TOL`` 1e-6 of an uninterrupted run;
   bit-equality printed). Times printed, none asserted; phase 9h, the
   mesh layer, in a process of its own (a world-size-1 NCCL group, a
   ``(1, 1)`` ``("data", "model")`` CUDA mesh; one card cannot hold a
   multi-rank NCCL mesh, and the CPU tests hold the multi-rank behaviour):
   (a) ``mamba2-2.7b`` in bf16 at full width and depth, 2 steps of
   ``jit_train_step`` under ``make_policy(cfg, mesh)`` on 9g's batch shape
   against 2 steps of ``build_train_step`` from the same state (both drawn
   from one seed), each step exactly 2 x 64 ``ssd_intra`` launches (the
   sharded ones through ``local_map``), losses within ``MESH_TOL`` 1e-5
   relative, ms and peak memory a step beside 9g's (the sharded state laid
   out before its first step, the plain one dropped); (b) the elastic
   restore on the smoke model: saved unsharded after one step, restored
   onto the mesh with ``train_state_specs`` and stepped, the loss within
   ``RESTORE_TOL`` 1e-6 of the unsharded continuation's; (c)
   ``qwen2-1.5b`` in bf16, all 28 layers, under each attention policy:
   the (1, 1) mesh's own (``head_tp``) and the one it takes on the 16x16
   mesh (``context``: its 12 heads on 16): a 2 x 1024 prefill through
   ``forward`` with and without the policy, then ``MESH_DECODE`` 8 greedy
   steps of ``jit_serve_step`` (``cache_specs``; the decode core on the
   sequence-sharded cache, its softmaxes combined by DTensor all-reduces)
   against the unsharded ``decode_step``, logits within ``MESH_TOL``, no
   kernel launched; (d) ``olmoe-1b-7b``'s smoke model in fp32 under each
   MoE policy (``expert``, ``ffn``): one ``jit_train_step`` on a
   ``MESH_MOE_BATCH`` batch and ``MESH_MOE_DECODE`` 2 greedy
   ``jit_serve_step`` steps (routing on each rank's own tokens) against
   the unsharded step and decode, loss and logits within ``MESH_TOL``, no
   kernel launched; (a)'s loss runs through the vocabulary-parallel NLL's
   all-reduces;
10. the batched engine (``BATCHES``: 16 tensors of 256^3 at R = 32 in fp32
    and bf16, 64 of 96^3 at R = 16, 8 of 64^4 at R = 16): batched
    ``repro_torch.mttkrp`` in every mode with per-element and with shared
    factors, batched ``contract_partial`` on the fused and dimension-tree
    nodes, batched ``multi_ttm`` on every keep and the core (ranks 16), each
    exactly one kernel launch and at most one ``splitk_reduce``, each
    against the kernel's plain version on the same batched operands (the
    MTTKRP kernels' with its product taken in float64, ``mttkrp64``) and
    against a loop of B unbatched calls (B launches), to 1e-5 (fp32
    outputs) or ``TOL["bfloat16"]`` (bf16 ones); each kernel's batched call
    and its loop timed back to back (CUDA events) and as device time (CUDA
    graphs); then ``cp_als_batched`` on 16 x 256^3 at R = 32 (10
    iterations, exactly 3 ``mttkrp3`` launches an iteration, fits within
    1e-4 of a loop of 16 ``cp_als`` runs from the same starts) and
    ``tucker_hooi_batched`` on 16 x 256^3 at ranks 16 (5 sweeps, exactly 3
    ``multi_ttm_keep`` launches a sweep, fits within 1e-4 of a loop of 16
    ``tucker_hooi`` runs), each timed against its loop;
11. the decomposition server (``SERVE_QUEUE``, ``SERVE_4WAY``) on
    ``backend="auto"`` with an empty tune cache: a mixed queue of 16
    requests near 256^3 at R = 32 and 64 near 96^3 at R = 16, then 8 near
    64^4 at R = 16, each flushed once untimed and once timed; exactly one
    ``cp_als_batched`` call a bucket and N MTTKRP launches an iteration it
    ran (counts set to 0 before the timed flush, read after); every request
    against a direct ``cp_als`` from the same start for the same iterations
    and its float64 run, request by request: within 1e-4 of the direct run
    in each of fit, weights and factors where the direct run is within
    ``SERVE_SOUND`` of float64 there, and everywhere no further from
    float64 than twice the direct run plus 1e-4, and at most
    ``SERVE_CAP``; after one iteration of a fresh server, every request
    within 1e-4 of its direct run in fit, weights and factors;
    requests/s of the flush against the loop of direct
    calls; then the cold and the warm start (``--serve-once``: two
    processes in turn on one fresh ``compilation_cache`` directory, the
    first builds ``mttkrp.cu``, the second loads it; the warm one must
    reach its first result sooner);
12. the tuner (``TUNE_PROBLEM``) on an isolated cache: ``tune_mttkrp``,
    ``tune_partial`` (the fused sweep's k = 1 edge), ``tune_multi_ttm``
    and ``tune_sweep`` at 1000^3, every candidate's time, plan and error
    recorded, the winner the fastest measured and the chooser's plan among
    the candidates, every key a hit from a fresh ``PlanCache`` and carrying
    the card's name and the torch version; ``cp_als`` on ``backend="auto"``
    (``per_mode``) and with ``sweep="auto"`` against ``cuda`` (fits within
    1e-4, exactly the launches the resolved decisions call for); the host's
    µs an engine call on a cache hit, through the default cache and through
    ``cache_path``, against ``cuda`` (at most 1.3x); ``calibrate`` on
    ``CALIBRATION`` and
    its report;
13. observability (``OBSERVE_CP``, ``SPAN_PROBE``, ``AUDITS``,
    ``OBSERVE_TUNE``): (a) CP-ALS at 1000^3, R = 64, 3 iterations on each
    schedule and HOOI at ranks 32, 2 sweeps, with ``observe=True`` inside
    one ``repro_torch.Trace`` exported as JSONL: the dispatch events equal
    the contractions an iteration (``SPANS_PER_ITER``) times the
    iterations, by kind; each is ``cuda`` with the plan its wrapper launched
    (read back through ``plan_from_dict``), ``modeled_words`` the model
    plan's against ``Memory.h100_smem`` and the bound under it; the
    iteration events carry the fits; ``engine.cuda_dispatches`` rose by the
    dispatch events; the fits and factors equal untraced runs from the same
    factors bit for bit; ``python -m repro_torch.observe.report`` on the
    file exits 0 (its table printed); (b) the host µs of one engine call at
    64^3, R = 16 with no trace against a trace whose gate refuses the
    call, then against traced calls, 200 calls of each state, the pair
    interleaved call by call: the first two within ``GATE_TOL`` 5 %
    (medians of the per-call times); and ``per_mode``'s ms an iteration at
    1000^3 with and without a trace; (c) one traced ``per_mode``
    iteration under ``torch.profiler``: every Hopper kernel it launches lies
    under its dispatch's ``record_function`` range, one MTTKRP kernel a
    range, with the device ms under each; a CUDA graph captured under an
    active trace records no event and replays to the eager result; (d)
    ``audit_mttkrp`` at 1000^3 (modes 0 and 1) and 180^4 (mode 0),
    ``audit_multi_ttm`` at 1000^3, ranks 32 (keep 0 and the core): each
    row's triple and ratios, measured at least the operands and the output
    once; (e) phase 11's mixed flush of 80 requests under a trace: one
    ``serve_bucket`` event a bucket, one ``serve_request`` a request, one
    ``cp_als_batched_iter`` an iteration a bucket ran; ``tune_mttkrp`` at
    256^3, R = 32 on an isolated cache: one ``tune_search`` event,
    ``tune.candidates_measured`` up by its candidates, one
    ``tune.search_time_us`` observation, one ``tune.cache_hits`` on the
    replay;
14. the distributed path (``DIST_RANKS`` = 4 ranks on the one card, each a
    ``--dist-rank`` process on a gloo group over a file store; the ranks
    load the libraries phase 2 built, with no ``nvcc`` on their path):
    (a) ``repro_torch.cp_als`` on a distributed ``cuda`` context at 1000^3,
    R = 64, 10 iterations after one untimed, on the grid ``choose_cp_grid``
    picks for 4 ranks, against the sequential ``cuda`` ``per_mode`` run
    from the same factors (made by this process meanwhile): fits within
    ``DIST_TOL`` 1e-4 a step, the gathered factors and weights within 1e-4
    of their largest magnitude, every rank's gathered result the same, a
    sweep's counted collective bytes ``stationary_sweep_words`` x 4 plus
    the fit's all-reduce exactly on every rank, exactly 3 ``mttkrp3``
    launches a rank an iteration and no other counted kernel; ms an
    iteration split into collectives and local work (no speed figure:
    four ranks share one card); (b) the same with ``overlap="ring"``
    (launches: one a ring arrival); (c) Alg 3 at 180^4, R = 32 on
    (1, 1, 2, 2), mode 0 (one ``mttkrpn`` a rank), and Alg 4 at 1000^3,
    R = 64, p0 = 2, (2, 1, 1), mode 0 (one ``mttkrp3`` a rank), each rank's
    block against the plain MTTKRP on the card within ``ALG_TOL`` 1e-5
    and its bytes Eq (12) / Eq (16) x 4 exactly; (d) ``repro_torch.tucker_hooi``
    on a distributed ``cuda`` context (``DIST_TUCKER``: 1000^3, ranks 32,
    5 sweeps after one untimed, from HOSVD), ``overlap`` none and ring,
    against the sequential ``cuda`` run from the same HOSVD (made by this
    process): the grid ``choose_tucker_grid`` picks, a sweep's counted
    bytes ``multi_ttm_sweep_words`` x 4 exactly on every rank, exactly 3
    ``multi_ttm_keep`` launches a rank a sweep and no other counted kernel,
    every rank's factors and core the same bits, fits within ``DIST_TOL``
    a sweep, factors and core within ``DIST_CORE_TOL`` 1e-3 of their
    largest magnitude; ms a sweep split into collectives and local work;
    (e) ``cp_compressed_mean`` (``DIST_COMPRESS``: a 4096 x 14336 fp32
    gradient a rank, rank 6, 25 sweeps) over the whole group: every rank's
    reconstruction the same bits, its relative error against the true mean
    under ``COMPRESS_TOL`` 0.05, the all-reduce's operand bytes
    ``sweeps * sum(dims) * rank * 4`` exactly and no operand as large as the
    gradient; one ``compressed_gradient`` step at rank 8, one sweep
    (``COMPRESS_STEP``): 589,856 operand bytes, ``compression_ratio`` 398.2;
15. the static verifier against the card: (a) ``verify_plans()`` and
    ``check_kernel_plans()`` give no finding, and every kernel-plan case's
    shared-memory mirror equals the built library's own count; (b) for
    every case of ``verify.kernels.kernel_cases()`` the launch grid the C
    launcher takes (its ``repro_*_grid`` function) equals the Python
    mirror's; (c) the write probe: every case's wrapper on real inputs,
    launched from the ``-DREPRO_WRITE_PROBE`` build of its source (built in
    phase 2 beside the production build) and from the production library:
    each element of each buffer each launch writes (workspace, P, output,
    and the split-K reduction's output) counts exactly 1, the overflow slot
    0, the buffers are the mirror's, the two outputs are bit-equal, and no
    wrapper's count moves for the probe's launches; one JSON line a case;
    (d) ``python -m repro_torch.verify`` in a subprocess exits 0 with all
    five analyzers and no finding, and ``verify_dtypes(device="cuda")``
    gives no finding, every Hopper launch it records writing float32;
16. the dry run (``python -m repro_torch.launch.dryrun``, one subprocess a
    cell, ``DRYRUN_AT_ONCE`` at a time, records in a temporary directory):
    one cell of each family on the 16x16 mesh of a fake process group,
    ``DRYRUN_CELLS`` (the six ``decode_32k`` cells and ``whisper-tiny``'s
    ``train_4k``, all at full depth), on this machine's torch, whose
    DTensor rules differ from other releases'; each exits 0 with
    ``status: "ok"``, its seconds and headline numbers printed (mem/dev,
    FLOPs/dev, collectives), then its count and ring bytes of each
    collective kind, a Shard-to-Shard redistribution counted as the
    all-to-all the card sends, ``mamba2-2.7b``'s ``argument_bytes``
    equal to the reference's record, ``MAMBA_ARGUMENT_BYTES``,
    ``qwen2-1.5b``'s and ``qwen2-vl-72b``'s FLOPs a device at most
    ``DECODE_FLOPS_LIMIT`` 1.25 times the reference's,
    ``DECODE_REF_FLOPS``; ``mamba2-2.7b``'s peak at most 1.25 times the
    record's, ``MAMBA_PEAK_BYTES``, and its ring bytes at most the
    record's, ``MAMBA_RING_BYTES`` (``MAMBA_LIMITS``), both printed beside
    the numbers before the vocabulary-parallel lookup; the one-layer cells
    of ``LAYER_REF`` (``run_cell(layers=1)``, a process each):
    ``mamba2-2.7b prefill_32k``'s peak and FLOPs, ``nemotron-4-340b
    train_4k``'s ring bytes (at most the reference's), peak and FLOPs,
    ``mamba2-2.7b
    train_4k``'s FLOPs, ring bytes (at most 0.25 times: the gated norm on
    each rank's own channels) and peak, and ``qwen2-vl-72b
    prefill_32k``'s peak, each at most its ``LAYER_LIMITS`` multiple of
    the reference's at one layer, printed beside the parent's
    (``LAYER_BEFORE``) and with each collective kind's count and ring
    bytes, ``mamba2-2.7b train_4k``'s ring bytes also beside torch 2.13's
    count (``MAMBA_TRAIN_RING_213``); and that cell once more beside
    ``CommDebugMode`` (``COMM_CHECK``), whose count of each collective
    kind must equal the dry run's counter's and the CLI's record's, kind by
    kind, with all-to-alls among them; no GPU is used;
17. the seconds each phase took, one JSON line per kernel and shape (times
    from CUDA events), the ``nvidia-smi`` line, and one ``{"kernels":
    [...]}`` line, its launches summed over the main paths and phase 14's
    ranks;
18. the last line, ``{"ok": true, "device": {...}}``.

All data are made on the card from ``--seed`` with a ``torch.Generator``.
Matmuls run in full fp32 (TF32 off), so the plain versions and the einsum
yardstick are exact fp32.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))

# The H100's published peaks and the bound rule every ``bound_ms`` is taken
# by (bytes at the HBM rate, operations at the type's peak rate, the
# MTTKRP's and the SSD term's products as the tensor cores run them).
from repro_torch.analysis.roofline import H100, bound, mma_bound, ssd_bound  # noqa: E402
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"mttkrp3": "mttkrp.cu", "mttkrpn": "mttkrp.cu", "splitk_reduce": "mttkrp.cu",
          "fused_pair": "sweep.cu", "mttkrp_partial": "sweep.cu",
          "multi_ttm_keep": "multi_ttm.cu", "ssd_intra": "ssd_intra.cu"}
REPLACES = {
    "mttkrp3": "src/repro/kernels/mttkrp3.py:121",
    "mttkrpn": "src/repro/kernels/mttkrpn.py:208",
    "splitk_reduce": "src/repro/kernels/mttkrp3.py:67",
    "fused_pair": "src/repro/kernels/sweep.py:140",
    "mttkrp_partial": "src/repro/kernels/mttkrpn.py:148",
    "multi_ttm_keep": "src/repro/kernels/multi_ttm.py:127",
    "ssd_intra": "src/repro/kernels/ssd_intra.py:84",
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: HOOI fits as ``tucker_hooi`` reports them, in fp32: the limit on the gap
#: between two summation orders (cuda against einsum), and on a fit's drop
#: from one sweep to the next. The fit ``1 - sqrt(||X||^2 - ||G||^2) / ||X||``
#: subtracts two fp32 numbers that agree to 1 %, and ``G`` carries the fp32
#: eigenvectors' departure from orthonormality to first order, so converged
#: fits move by up to 1.6e-5 at 180^4 on either backend; Y rounded to bf16
#: makes them drop by 3.7e-5 (PERF.md, PR 13).
FIT_NOISE = 1e-4
FIT_DROP = 3e-5
#: The same fits recomputed in float64 from the factors' subspaces
#: (``subspace_fit``): non-decreasing from the HOSVD subspace through every
#: sweep, and the same on both backends, to this limit. Sound runs stay
#: within 6e-12; Y rounded to bf16 moves them by 2.2e-7 (PERF.md, PR 13).
SUBSPACE_TOL = 1e-9
#: Launches per CP-ALS iteration of each schedule, (3-way, 4-way), derived
#: from engine/sweep.py:fused_als_sweep and engine/tree.py:_solve_tree.
PER_ITER = {
    "per_mode": ({"mttkrp3": 3}, {"mttkrpn": 4}),
    "fused": ({"fused_pair": 1, "mttkrp_partial": 1, "mttkrp3": 1},
              {"fused_pair": 1, "mttkrp_partial": 2, "mttkrpn": 1}),
    "dimtree": ({"mttkrp3": 1, "mttkrpn": 1, "mttkrp_partial": 2},
                {"mttkrp3": 2, "mttkrp_partial": 4}),
}
#: Phase 6b: CP-ALS on a matrix (dims, rank, iterations): a 2-way tensor
#: runs ``mttkrpn`` with one contraction axis, twice an iteration.
MATRIX = ((10000, 10000), 64, 5)
COUNTED = ("mttkrp3", "mttkrpn", "fused_pair", "mttkrp_partial", "multi_ttm_keep",
           "ssd_intra")
KERNELS = ("mttkrp3", "mttkrpn", "splitk_reduce", "fused_pair", "mttkrp_partial",
           "multi_ttm_keep", "ssd_intra")
#: Phase 16's cells: one of each family, on 16x16 at full depth.
DRYRUN_CELLS = (("mamba2-2.7b", "decode_32k"), ("qwen2-1.5b", "decode_32k"),
                ("olmoe-1b-7b", "decode_32k"), ("jamba-v0.1-52b", "decode_32k"),
                ("qwen2-vl-72b", "decode_32k"), ("whisper-tiny", "decode_32k"),
                ("whisper-tiny", "train_4k"))
#: Dry runs at once (each is one CPU process).
DRYRUN_AT_ONCE = 3
#: ``cost.flops`` of the reference's ``A decode_32k 16x16`` records, from
#: ``python -m repro.launch.dryrun --arch A --shape decode_32k`` (jax 0.9.0
#: on the CPU), and the multiple of them the port may count: the decode
#: core attends each rank's own part of the sequence-sharded cache, under
#: ``context`` (qwen2-1.5b) and ``head_tp`` (qwen2-vl-72b).
DECODE_REF_FLOPS = {"qwen2-1.5b": 6_674_448_384, "qwen2-vl-72b": 134_540_689_408}
DECODE_FLOPS_LIMIT = 1.25
#: ``memory.argument_bytes`` of the reference's
#: ``results/dryrun/mamba2-2.7b__decode_32k__16x16.json``.
MAMBA_ARGUMENT_BYTES = 131_754_272
#: ``memory.peak_bytes_est`` and ``collectives.ring_bytes`` of the same
#: record, and the multiple of each the port may count: the token table
#: stays split over the vocabulary (the vocabulary-parallel lookup).
MAMBA_PEAK_BYTES = 253_726_152
MAMBA_RING_BYTES = 696_134_912
MAMBA_LIMITS = {"peak_bytes_est": 1.25, "ring_bytes": 1.0}
#: The same two numbers before the lookup was vocabulary-parallel (every
#: rank gathered the whole table for each token): ``python -m
#: repro_torch.launch.dryrun --arch mamba2-2.7b --shape decode_32k`` at
#: commit f287166, torch 2.13 on a host CPU.
MAMBA_BEFORE = {"peak_bytes_est": 664_316_192, "ring_bytes": 560_186_880}
#: Phase 16's one-layer cells (``run_cell(layers=1)``, a process each): the
#: reference's numbers at one layer (``repro.launch.dryrun.run_cell`` with
#: the config cut to one layer, as ``tests/test_torch_dryrun_reference.py``
#: cuts it; jax 0.9.0 on the CPU), the multiple of each the port may count,
#: and the port's at commit dda618d, before the dry run counted a
#: Shard-to-Shard redistribution as the all-to-all the card sends (it
#: counted the CPU mesh's gather of the whole dimension: ``python3
#: scripts/dryrun_layers.py sweep``, torch 2.13 on a host CPU).
LAYER_REF = {("mamba2-2.7b", "prefill_32k"): {"peak_bytes_est": 2_068_277_120,
                                              "flops": 350_944_526_336},
             ("nemotron-4-340b", "train_4k"): {"ring_bytes": 234_624_581_848,
                                               "peak_bytes_est": 11_382_347_112,
                                               "flops": 229_918_189_289_472},
             ("mamba2-2.7b", "train_4k"): {"flops": 4_469_181_906_944,
                                           "ring_bytes": 14_495_420_569,
                                           "peak_bytes_est": 1_253_303_904},
             ("qwen2-vl-72b", "prefill_32k"): {"peak_bytes_est": 6_012_716_672}}
LAYER_LIMITS = {("mamba2-2.7b", "prefill_32k"): {"peak_bytes_est": 1.25, "flops": 1.25},
                ("nemotron-4-340b", "train_4k"): {"ring_bytes": 1.0, "peak_bytes_est": 1.25,
                                                  "flops": 1.25},
                ("mamba2-2.7b", "train_4k"): {"flops": 1.25, "ring_bytes": 0.25,
                                              "peak_bytes_est": 1.25},
                ("qwen2-vl-72b", "prefill_32k"): {"peak_bytes_est": 1.25}}
LAYER_BEFORE = {("mamba2-2.7b", "prefill_32k"): {"peak_bytes_est": 1_935_586_248,
                                                 "flops": 354_971_058_176},
                ("nemotron-4-340b", "train_4k"): {"ring_bytes": 337_540_792_355,
                                                  "peak_bytes_est": 10_408_349_728,
                                                  "flops": 222_960_342_269_952},
                ("mamba2-2.7b", "train_4k"): {"flops": 4_489_750_773_760,
                                              "ring_bytes": 3_302_690_435,
                                              "peak_bytes_est": 666_934_620},
                ("qwen2-vl-72b", "prefill_32k"): {"peak_bytes_est": 6_469_627_912}}
#: ``mamba2-2.7b train_4k``'s ring bytes at one layer as torch 2.13 counts
#: them on a host CPU (``python3 scripts/dryrun_layers.py sweep``, this
#: tree), printed beside this machine's count: DTensor's rules differ
#: between releases, and this cell's gated norm was the one site known to
#: count differently.
MAMBA_TRAIN_RING_213 = 3_302_690_435
#: One cell ``argv[1:3]`` at one layer (records in ``argv[3]``): its numbers
#: as one JSON line.
LAYER_CELL = r"""
import json, sys
from repro_torch.launch import dryrun

rec = dryrun.run_cell(sys.argv[1], sys.argv[2], False, sys.argv[3], layers=1)
print(json.dumps({"status": rec["status"], "torch": rec["torch"], "trace_s": rec["trace_s"],
                  "flops": rec["cost"]["flops"], "ring_bytes": rec["collectives"]["ring_bytes"],
                  "peak_bytes_est": rec["memory"]["peak_bytes_est"],
                  "by_kind": rec["collectives"]["by_kind"]}))
"""
#: Phase 16's check of the dry run's collective counter on this machine's
#: torch: the cell ``argv[1:3]`` dry-run again (records in ``argv[3]``),
#: ``CommDebugMode`` entered around its step beside the counter; prints
#: both counts by kind as one JSON line. Its Shard-to-Shard redistributions
#: reach both as ``_dtensor::shard_dim_alltoall``, the card's all-to-all.
COMM_CHECK = r"""
import contextlib, json, sys
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.launch import dryrun

comm, apart = CommDebugMode(), dryrun.propagation_apart

@contextlib.contextmanager
def watched():
    with apart(), comm:
        yield

dryrun.propagation_apart = watched
rec = dryrun.run_cell(sys.argv[1], sys.argv[2], False, sys.argv[3])
counts = {}
for op, n in comm.get_comm_counts().items():
    name = op.__name__.split(".")[-1]
    kind = dryrun.COLLECTIVE_KINDS.get(name, name)
    counts[kind] = counts.get(kind, 0) + n
print(json.dumps({"counter": {k: v["count"] for k, v in rec["collectives"]["by_kind"].items()},
                  "comm_debug_mode": counts}))
"""
#: Phase 9: Mamba2-2.7b's SSD shape at 4 prompts of 4096 tokens (BC = 4 x
#: 4096 / 256 chunks), the prefill and decode it serves, and the duality check.
SSD_SHAPE = {"bcn": 64, "q": 256, "n": 128, "h": 80, "p": 64}
PREFILL = (4, 4096)
DECODE_STEPS = 32
DUAL_LEN = 512
#: Max |prefill logits - decode logits| / max |prefill logits| of the fp32
#: model over DUAL_LEN tokens (phase 9c). Sound runs read 1.13e-5; the
#: kernel's dt weights scaled by 1.001 read 9.6e-4, its diagonal dropped
#: 0.57 (PERF.md, section 6).
DUAL_TOL = 1e-4
#: Phase 9d, the dense decoders (ROADMAP Queue 1 item 15a): each config's
#: layers (None: all of them), cut so that each model fits the one card's
#: 80 GB (nemotron-4-340b's 2 layers and untied 256,000-row table and head
#: are 16.3 G parameters, 33 GB in bf16) and the phase its 30 s; the prefill
#: (prompts, tokens) and decode cache length; the fp32 duality check
#: (config, layers, prompt tokens, decode positions).
DENSE_LAYERS = {"qwen2-1.5b": None, "deepseek-coder-33b": 2, "yi-34b": 2, "nemotron-4-340b": 2}
DENSE_PREFILL = (2, 1024)
DENSE_DUAL = ("qwen2-1.5b", 4, 2048, 256)
#: Phase 9e, the MoE models and the hybrid (ROADMAP Queue 1 item 15b),
#: served at phase 9d's sizes: each config's layers (None: all of them);
#: jamba-v0.1-52b cut to one period of 8 (13.3 G parameters, 27 GB in bf16;
#: its 32 layers would need about 104 GB). The MoE layer's check: tokens,
#: and the limit on max |d| / max |plain| with the routing held fixed. The
#: SSD kernel at jamba's shape: 2 x 1024 tokens are 8 chunks of 256, N = 16,
#: H = 128, P = 64.
MOE_LAYERS = {"olmoe-1b-7b": None, "granite-moe-3b-a800m": None, "jamba-v0.1-52b": 8}
#: Phase 9f, the VLM backbone and the encoder-decoder model (ROADMAP Queue
#: 1 item 15c): qwen2-vl-72b cut to 4 layers (6.0 G parameters, 12.0 GB in
#: bf16; its 80 are 72.7 G, 145 GB); whisper-tiny whole: the encoder's
#: frames (Whisper's 30 s window), the decoder's start token
#: (<|startoftranscript|>), the fp32 duality's decoder tokens.
VLM_LAYERS = {"qwen2-vl-72b": 4}
WHISPER_FRAMES = 1500
WHISPER_START = 50258
WHISPER_DUAL_TOKENS = 128
#: Phase 9g, the training path (ROADMAP Queue 1 items 15d and 15e): the
#: SSD term's backward alone at the train shape (2 x 2048 tokens are BC = 16
#: chunks of 256; N = 128, H = 80, P = 64), within SSD_GRAD_TOL of each
#: gradient's largest magnitude of autograd through the plain version; the
#: gradient check through the model (mamba2-2.7b in fp32 at full width, cut
#: to 2 layers, on 2 x 512 tokens) against the same model with the plain
#: version swapped in, within TRAIN_GRAD_TOL of each leaf's largest
#: gradient, the three remat modes within REMAT_TOL of one another, and
#: FIXED_STEPS AdamW steps (peak lr FIXED_LR, warmup 1) on that batch; the
#: slice at full width and depth (bf16, 64 layers) on a fixed 2 x 2048-token
#: batch, one untimed step and TRAIN_TIMED timed; the launcher's smoke run
#: (LAUNCHER_ARGS) and the loop's recovery from a failure at step 6, within
#: LOOP_TOL of an uninterrupted run.
TRAIN_SSD = {"bcn": 16, "q": 256, "n": 128, "h": 80, "p": 64}
SSD_GRAD_TOL = {"f32": 1e-5, "x_bf16": 1e-2}
TRAIN_GRAD = (2, (2, 512))
TRAIN_GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
FIXED_STEPS, FIXED_LR = 5, 1e-3
TRAIN_BATCH = (2, 2048)
TRAIN_TIMED = 3
LAUNCHER_ARGS = ["--arch", "mamba2-2.7b", "--smoke", "--steps", "20", "--batch", "8", "--seq",
                 "64", "--ckpt-every", "5"]
LOOP_TOL = 1e-6
#: Phase 9h, the mesh layer on a (1, 1) CUDA mesh: (a) the sharded train
#: step's losses, (c) the sharded decode's logits and (d) the sharded MoE
#: model's loss and logits within MESH_TOL (relative) of the unsharded runs; (b) the restored-and-stepped loss
#: within RESTORE_TOL of the unsharded continuation's; (c) MESH_DECODE
#: greedy steps after a MESH_PREFILL prefill. Its seed, on top of --seed.
MESH_TOL = 1e-5
RESTORE_TOL = 1e-6
MESH_PREFILL = (2, 1024)
MESH_DECODE = 8
MESH_SEED = 4
#: Phase 9h (d): the MoE smoke model's train batch and its decode steps.
MESH_MOE_BATCH = (4, 128)
MESH_MOE_DECODE = 2
MOE_TOKENS = 2048
MOE_TOL = 1e-5
JAMBA_SSD = {"bcn": 8, "q": 256, "n": 16, "h": 128, "p": 64}
#: Phase 10, the batched engine: (B, element shape, R, dtypes). 16 x 256^3
#: (1.07 GB in fp32) is a bucket of mid-sized requests, 64 x 96^3 the
#: small-request bucket where the host's cost a call sets the pace, 8 x 64^4
#: a 4-way bucket (the partial kernel's k = 2 nodes, the MTTKRP kernel's
#: generic path).
BATCHES = [(16, (256, 256, 256), 32, ("float32", "bfloat16")),
           (64, (96, 96, 96), 16, ("float32",)),
           (8, (64, 64, 64, 64), 16, ("float32",))]
#: Phase 10's drivers: (B, element shape, CP rank, CP iterations, Tucker
#: rank, HOOI sweeps).
BATCHED_DRIVERS = (16, (256, 256, 256), 32, 10, 16, 5)
#: Phase 11, serving: the mixed queue of one flush, as (requests, extents
#: drawn in [lo, hi], R): 16 mid-sized requests (one 16 x 256^3 bucket) and
#: 64 small ones (one 64 x 96^3 bucket, host-bound when looped), then a
#: 4-way queue (one 8 x 64^4 bucket); fp32, ``pad_to`` 8, SERVE_ITERS
#: iterations at most, the server's default tol.
SERVE_QUEUE = [(16, (249, 256), 32, 3), (64, (89, 96), 16, 3)]
SERVE_4WAY = [(8, (57, 64), 16, 4)]
SERVE_ITERS = 10
#: The iterations over which every served result must equal its direct run
#: to 1e-4: one update of every mode (later iterations amplify fp32
#: rounding: the 4-way requests' factors differ by 2.0e-5 after one, 1.1e-4
#: after two: PERF.md section 6).
SERVE_EXACT_ITERS = 1
#: After SERVE_ITERS iterations, request by request and in each of (fit,
#: weights, factors): where the direct run is within SERVE_SOUND of its
#: float64 run (a tenth of the 1e-4 limit) the served result must be within
#: SERVE_TOL of the direct run; everywhere it must be within twice the direct
#: run's distance from float64 plus SERVE_TOL of float64, and within
#: SERVE_CAP of it (5x the worst served reading, PERF.md section 6).
SERVE_TOL = 1e-4
SERVE_SOUND = 1e-5
SERVE_CAP = (1e-3, 1e-2, 1e-2)
#: The small bucket the cold and the warm start serve, each in a process of
#: its own: (requests, extents, R, iterations).
SERVE_START = (8, (25, 32), 8, 5)
#: Phase 12, tuning: the searches' problem (shape, R, Multi-TTM ranks), the
#: auto runs' iterations, the host-cost probe (shape, R, calls) and the
#: calibration's shapes.
TUNE_PROBLEM = ((1000, 1000, 1000), 64, 32)
AUTO_ITERS = 3
HOST_PROBE = ((64, 64, 64), 16, 400)
CALIBRATION = (((256, 256, 256), 32), ((384, 320, 256), 32), ((512, 384, 256), 16))
#: Phase 13, observability: the traced CP-ALS runs (shape, R, iterations a
#: schedule) and HOOI on the same shape (Tucker rank, sweeps); the span-cost
#: probe (shape, R, rounds, calls a round: each state 200 calls, the states
#: interleaved round by round) and the limit on the refused gate's cost
#: against no trace; the audits (kind, shape, R, mode or keep); the tuner's
#: problem on an isolated cache.
OBSERVE_CP = ((1000, 1000, 1000), 64, 3)
OBSERVE_TUCKER = (32, 2)
SPAN_PROBE = ((64, 64, 64), 16, 200)
GATE_TOL = 0.05
AUDITS = [("mttkrp", (1000, 1000, 1000), 64, 0), ("mttkrp", (1000, 1000, 1000), 64, 1),
          ("mttkrp", (180, 180, 180, 180), 32, 0), ("multi_ttm", (1000, 1000, 1000), 32, 0),
          ("multi_ttm", (1000, 1000, 1000), 32, None)]
OBSERVE_TUNE = ((256, 256, 256), 32)
#: Contractions an iteration of each schedule dispatches on a 3-way tensor,
#: by span kind (engine/sweep.py:fused_als_sweep, engine/tree.py:_solve_tree).
SPANS_PER_ITER = {"per_mode": {"mttkrp": 3},
                  "fused": {"fused_pair": 1, "contract_partial": 1, "mttkrp": 1},
                  "dimtree": {"contract_partial": 4}}
DISPATCH_KINDS = ("mttkrp", "contract_partial", "multi_ttm", "fused_pair")
#: Phase 14, the distributed path: DIST_RANKS ranks on the one card over
#: gloo (NCCL refuses two ranks on one device), each a process of its own
#: (``--dist-rank``). The CP sweep (shape, R, iterations) on the grid
#: ``choose_cp_grid`` picks; Alg 3 (shape, R, grid, mode) through
#: ``mttkrpn``; Alg 4 (shape, R, p0, grid, mode). DIST_TOL bounds the
#: fits a step and the factors (of their largest magnitude) against the
#: sequential ``cuda`` run; ALG_TOL the Alg 3/4 outputs against the plain
#: MTTKRP. The seed of the phase's data, on top of ``--seed``.
DIST_RANKS = 4
DIST_CP = ((1000, 1000, 1000), 64, 10)
DIST_ALG3 = ((180, 180, 180, 180), 32, (1, 1, 2, 2), 0)
DIST_ALG4 = ((1000, 1000, 1000), 64, 2, (2, 1, 1), 0)
DIST_TOL = 1e-4
ALG_TOL = 1e-5
DIST_SEED = 14
#: 14d: the Tucker sweep (shape, ranks, sweeps) on the grid
#: ``choose_tucker_grid`` picks, from HOSVD; DIST_CORE_TOL bounds the
#: factors and the core (of their largest magnitude) against the sequential
#: ``cuda`` run, the fits a sweep DIST_TOL. 14e: CP gradient compression of
#: an MLP gradient (shape, rank, sweeps) a rank, the relative error of the
#: reconstruction against the true mean under COMPRESS_TOL; one
#: ``compressed_gradient`` step at (rank, sweeps) COMPRESS_STEP.
DIST_TUCKER = ((1000, 1000, 1000), (32, 32, 32), 5)
DIST_CORE_TOL = 1e-3
DIST_COMPRESS = ((4096, 14336), 6, 25)
COMPRESS_STEP = (8, 1)
COMPRESS_TOL = 0.05
#: The Hopper kernels' device names, as the profiler reports them.
HOPPER_KERNEL = re.compile(r"mttkrp_mma_kernel|splitk_reduce_kernel|fused_pair_mma_kernel|"
                           r"streaming_partial_kernel|multi_ttm_mma_kernel")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warm):
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


def peak_extra_gb(fn) -> float:
    """GB that one call of ``fn`` holds on the card at its peak, above what
    was allocated before it (its result included)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def graph_ms(fn, reps: int = 50, rounds: int = 4) -> float:
    """Mean device time of ``fn`` with no host time between launches:
    ``reps`` calls captured in one CUDA graph, replayed ``rounds`` times
    between CUDA events. For kernels of a few microseconds, where
    :func:`cuda_ms` reads the host's launch rate instead of the card."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm on a side stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: the wrappers set a kernel's shared-memory limit
    # (cudaFuncSetAttribute, not a stream operation) at each launch
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want| / max |want|, max |got - want|)."""
    diff = float((got.float() - want.float()).abs().max())
    return diff / max(float(want.abs().max()), 1e-30), diff


#: Registers and spill bytes of each MTTKRP kernel instantiation, by
#: (dtype, NC, block_i, block_r), from ``-Xptxas -v``; NC is 2 for the 3-way
#: specialization, 0 for the generic kernel.
MMA_REGS: dict = {}


def ptxas_usage(log: str, pattern: str, key) -> dict:
    """``{key(match): (registers, spill bytes)}`` of the kernels whose
    mangled names match ``pattern``, from the compiler's report."""
    found, current = {}, None
    pat = re.compile(pattern)
    for line in log.splitlines():
        m = pat.search(line)
        if m:
            current = key(m)
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if current and spill:
            found[current] = [None, int(spill.group(1))]
        regs = re.search(r"Used (\d+) registers", line)
        if current and regs:
            found.setdefault(current, [None, 0])[0] = int(regs.group(1))
            current = None
    return {k: tuple(v) for k, v in found.items()}


def _dtype(mangled: str) -> str:
    return "float32" if mangled == "f" else "bfloat16"


def parse_mma_registers(log: str) -> dict:
    """``{(dtype, NC, block_i, block_r): (registers, spill bytes)}`` of
    ``mttkrp_mma_kernel<T, NC, MT, NT>``."""
    return ptxas_usage(log, r"_Z17mttkrp_mma_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E",
                       lambda m: (_dtype(m.group(1)), int(m.group(2)), 64 * int(m.group(3)),
                                  16 * int(m.group(4))))


#: Registers and spill bytes of the pair and Multi-TTM kernels, by (kernel,
#: dtype, row block, rank block), from ``-Xptxas -v``.
RING_REGS: dict = {}
#: Registers and spill bytes of the partial kernel, by (dtype, vec, rows
#: layout, rows a thread), from ``-Xptxas -v``.
PARTIAL_REGS: dict = {}


def parse_partial_registers(log: str) -> dict:
    """``{(dtype, vec, rows layout, rows a thread): (registers, spill bytes)}``
    of ``streaming_partial_kernel<T, V, ROWL, ROWS>``."""
    return ptxas_usage(log, r"_Z24streaming_partial_kernelI(f|13__nv_bfloat16)Li(\d+)ELb(\d)"
                            r"ELi(\d+)E",
                       lambda m: (_dtype(m.group(1)), int(m.group(2)), m.group(3) == "1",
                                  int(m.group(4))))


def parse_ring_registers(log: str, kernel: str, symbol: str) -> dict:
    """``{(kernel, dtype, rows, block_r): (registers, spill bytes)}`` of the
    ``symbol<T, MT, NT>`` instantiations."""
    return ptxas_usage(log, rf"_Z\d+{symbol}I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                       lambda m: (kernel, _dtype(m.group(1)), 64 * int(m.group(2)),
                                  16 * int(m.group(3))))


def mttkrp_launch(x, rank: int, specialized: bool) -> dict:
    """The MTTKRP kernel's launch for a canonical operand: its plan, shared
    memory, splits on this card, and registers and spills of the
    instantiation it runs."""
    import torch
    from repro_torch.engine.plan import (
        choose_mttkrp_kernel_blocks,
        mttkrp_kernel_grid,
        mttkrp_kernel_smem_bytes,
    )

    plan = choose_mttkrp_kernel_blocks(x.shape, rank, x.element_size())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dtype = str(x.dtype).split(".")[-1]
    regs, spills = MMA_REGS.get((dtype, 2 if specialized else 0, plan.block_i, plan.block_r),
                                (None, None))
    return {"plan": [plan.block_i, plan.block_k, plan.block_r, plan.stages],
            "smem_bytes": mttkrp_kernel_smem_bytes(plan, x.element_size(), x.ndim - 1),
            "splits": mttkrp_kernel_grid(x.shape, rank, plan, sms)[2],
            "registers": regs, "spill_bytes": spills}


def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import splitk
    from repro_torch.kernels.mttkrp3 import mttkrp3
    from repro_torch.kernels.mttkrpn import mttkrpn
    from repro_torch.kernels.multi_ttm import multi_ttm_keep
    from repro_torch.kernels.partial import mttkrp_partial
    from repro_torch.kernels.ssd_intra import ssd_intra
    from repro_torch.kernels.sweep import fused_pair

    return {"mttkrp3": mttkrp3, "mttkrpn": mttkrpn, "splitk_reduce": splitk.splitk_reduce,
            "fused_pair": fused_pair, "mttkrp_partial": mttkrp_partial,
            "multi_ttm_keep": multi_ttm_keep, "ssd_intra": ssd_intra}


def check(name: str, got, want, dtype: str) -> tuple[float, float]:
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite values")
    rel, diff = rel_err(got, want)
    if rel > TOL[dtype]:
        raise AssertionError(f"{name}: max|d|/max|plain| = {rel:.3e} > {TOL[dtype]}")
    return rel, diff


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def splitk_phase(gen, s: int, i: int, rank: int, smi: str, records: dict) -> None:
    """``splitk_reduce`` on a random ``(s, i, rank)`` workspace: against its
    plain version, bit for bit against the in-order slab sum, and timed."""
    import torch
    from repro_torch.kernels import splitk

    ws = torch.randn((s, i, rank), generator=gen, device="cuda")
    out = torch.empty((i, rank), device="cuda")
    rel, diff = check(f"splitk_reduce {s} slabs", splitk.splitk_reduce(ws, out).clone(),
                      splitk.splitk_reduce_plain(ws), "float32")
    in_order = torch.zeros_like(out)
    for slab in ws:  # the slabs added in slab order: the kernel's bits
        in_order += slab
    if not torch.equal(splitk.splitk_reduce(ws, out), in_order):
        raise AssertionError("splitk_reduce: not the bits of the in-order slab sum")
    n = i * rank
    b_ms, b_by = bound(n * s, 4, 0, n, (s - 1) * n, "float32")
    rec = {
        "kernel": "splitk_reduce", "shape": [s, i, rank], "dtype": "float32",
        "max_rel_err": rel, "max_abs_err": diff,
        # a few microseconds on the card, under the host's launch rate: device
        # times by CUDA graphs; beside them, the back-to-back call rate
        "timing": "cuda_graph",
        "kernel_ms": graph_ms(lambda: splitk.splitk_reduce(ws, out)),
        "plain_ms": graph_ms(lambda: splitk.splitk_reduce_plain(ws)),
        "library_ms": graph_ms(lambda: torch.sum(ws, 0)),
        "host_ms": {"kernel": cuda_ms(lambda: splitk.splitk_reduce(ws, out), reps=50),
                    "library": cuda_ms(lambda: torch.sum(ws, 0), reps=50)},
        "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
    }
    emit(rec)
    records.setdefault("splitk_reduce", []).append(rec)
    del ws, out, in_order
    torch.cuda.empty_cache()


def kernel_phases(gen, smi: str, records: dict) -> None:
    """Phases 3 and 4: every kernel against its plain version, timed."""
    import torch
    from repro_torch.core.mttkrp import einsum_spec
    from repro_torch.kernels import ops
    from repro_torch.kernels.mttkrp3 import mttkrp3, mttkrp3_plain
    from repro_torch.kernels.mttkrpn import mttkrpn, mttkrpn_plain

    def measure(kname, x, fs, mode, dtype, plain_ref, run_kernel, run_plain):
        xp, fsp = ops.canonicalize(x, fs, mode)
        fsp = [f.contiguous() for f in fsp]
        got = run_kernel(xp, fsp)
        rel, diff = check(f"{kname} mode {mode} {dtype}", got, plain_ref(xp, fsp), dtype)
        ins = [f for k, f in enumerate(fs) if k != mode]
        spec = einsum_spec(x.ndim, mode)
        rank = fs[0].shape[1]
        b_ms, b_by = mma_bound(x.numel(), x.element_size(), sum(f.numel() for f in ins),
                               x.shape[mode] * rank, 2.0 * x.numel() * rank, dtype)
        rec = {
            "kernel": kname, "shape": list(x.shape), "rank": rank, "mode": mode,
            "dtype": dtype, **mttkrp_launch(xp, rank, kname == "mttkrp3"),
            "max_rel_err": rel, "max_abs_err": diff,
            "kernel_ms": cuda_ms(lambda: run_kernel(xp, fsp)),
            "plain_ms": cuda_ms(lambda: run_plain(xp, fsp), reps=3, warm=1),
            "library_ms": cuda_ms(lambda: torch.einsum(spec, x, *ins), reps=3, warm=1),
            "transpose_ms": cuda_ms(lambda: ops.canonicalize(x, fs, mode), reps=3, warm=1)
            if mode else 0.0,
            "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
        }
        emit(rec)
        records.setdefault(kname, []).append(rec)
        del xp, fsp
        torch.cuda.empty_cache()

    # phase 3: 1000^3, R=64, fp32 then bf16, all modes; the generic variant
    dims, rank = (1000, 1000, 1000), 64
    x = torch.randn(dims, generator=gen, device="cuda")
    fs = [torch.randn((d, rank), generator=gen, device="cuda") / rank ** 0.5 for d in dims]
    plain_cache = {}

    def plain3(mode):
        def fn(xp, fsp):
            if mode not in plain_cache:
                plain_cache[mode] = mttkrp3_plain(xp, *fsp)
            return plain_cache[mode]
        return fn

    for mode in range(3):
        measure("mttkrp3", x, fs, mode, "float32", plain3(mode),
                lambda xp, fsp: mttkrp3(xp, *fsp), lambda xp, fsp: mttkrp3_plain(xp, *fsp))
        measure("mttkrpn", x, fs, mode, "float32", plain3(mode),
                lambda xp, fsp: mttkrpn(xp, fsp), lambda xp, fsp: mttkrpn_plain(xp, fsp))
        got = ops.mttkrp(x, fs, mode)  # the public path: transpose + kernel
        check(f"ops.mttkrp mode {mode}", got, plain_cache[mode], "float32")
    xb = x.to(torch.bfloat16)
    fsb = [f.to(torch.bfloat16) for f in fs]
    for mode in range(3):
        # bf16 inputs against the fp32 plain version of the fp32 data
        measure("mttkrp3", xb, fsb, mode, "bfloat16", plain3(mode),
                lambda xp, fsp: mttkrp3(xp, *fsp), lambda xp, fsp: mttkrp3_plain(xp, *fsp))
        got = ops.mttkrp(xb, fsb, mode, out_dtype=torch.float32)
        check(f"ops.mttkrp bf16 mode {mode}", got, plain_cache[mode], "bfloat16")

    # the split-K reduction at the main shape's workspace: the MTTKRP kernel's
    # split count there
    splitk_phase(gen, max(2, records["mttkrp3"][0]["splits"]), dims[0], rank, smi, records)
    del x, fs, xb, fsb, plain_cache
    torch.cuda.empty_cache()

    # phase 4: 180^4, R=32, fp32, all modes
    dims, rank = (180, 180, 180, 180), 32
    x = torch.randn(dims, generator=gen, device="cuda")
    fs = [torch.randn((d, rank), generator=gen, device="cuda") / rank ** 0.5 for d in dims]
    for mode in range(4):
        measure("mttkrpn", x, fs, mode, "float32", lambda xp, fsp: mttkrpn_plain(xp, fsp),
                lambda xp, fsp: mttkrpn(xp, fsp), lambda xp, fsp: mttkrpn_plain(xp, fsp))
    del x, fs
    torch.cuda.empty_cache()
    # the split-K reduction at this shape's workspace: many slabs of few outputs
    splits = next(r["splits"] for r in records["mttkrpn"] if r["shape"] == list(dims))
    splitk_phase(gen, max(2, splits), dims[0], rank, smi, records)


def sweep_kernel_phases(gen, smi: str, records: dict) -> None:
    """Phase 5: the fused-sweep kernels against their plain versions, at the
    shapes and in the positions the fused sweep and the dimension tree use
    them, timed beside their bounds and the einsum calls that compute the
    same function."""
    import torch
    import repro_torch
    from repro_torch.engine.plan import choose_pair_kernel_blocks, pair_kernel_grid
    from repro_torch.engine.sweep import _fused_pair
    from repro_torch.kernels import ops
    from repro_torch.kernels import partial as partial_mod
    from repro_torch.kernels import sweep as sweep_mod
    from repro_torch.kernels.mttkrp3 import mttkrp3, mttkrp3_plain
    from repro_torch.kernels.mttkrpn import mttkrpn, mttkrpn_plain
    from repro_torch.kernels.partial import mttkrp_partial, mttkrp_partial_plain
    from repro_torch.kernels.sweep import fused_pair, fused_pair_plain

    ein = repro_torch.ExecutionContext.create("einsum")

    def pair(x, fs, dtype, want):
        rank = fs[0].shape[1]
        got = fused_pair(x, fs[1:])
        rel_b, diff_b = check(f"fused_pair B0 {tuple(x.shape)} {dtype}", got[0], want[0], dtype)
        rel_p, diff_p = check(f"fused_pair P {tuple(x.shape)} {dtype}", got[1], want[1], dtype)
        del got
        lead = x.numel() // x.shape[-1]  # I0 * C_1..C_{N-2}: P's rows
        # the P product on the tensor cores (3xTF32 for fp32), the B0 fold beside it
        b_ms, b_by = mma_bound(x.numel(), x.element_size(), sum(f.numel() for f in fs[1:]),
                               x.shape[0] * rank + lead * rank,
                               2.0 * x.numel() * rank + 2.0 * lead * rank, dtype)
        plan = choose_pair_kernel_blocks(x.shape, rank, x.element_size())
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rec = {
            "kernel": "fused_pair", "shape": list(x.shape), "rank": rank, "dtype": dtype,
            "plan": [plan.block_i, plan.block_k, plan.block_r, plan.stages],
            "smem_bytes": sweep_mod.smem_bytes(plan, x.dtype, x.ndim - 1),
            "splits": pair_kernel_grid(x.shape, rank, plan, sms)[2],
            "registers": RING_REGS.get(("fused_pair", dtype, plan.block_i, plan.block_r)),
            "max_rel_err": max(rel_b, rel_p), "max_abs_err": max(diff_b, diff_p),
            "kernel_ms": cuda_ms(lambda: fused_pair(x, fs[1:])),
            "plain_ms": cuda_ms(lambda: fused_pair_plain(x, fs[1:]), reps=3, warm=1),
            "library": "2 torch.einsum calls (the einsum backend's P, then B0)",
            "library_ms": cuda_ms(lambda: _fused_pair(x, fs, ein), reps=3, warm=1),
            "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
        }
        emit(rec)
        records.setdefault("fused_pair", []).append(rec)

    def partial(node, fs, perm, where, want=None):
        """``node`` as the tree or sweep holds it; ``perm`` is the permute
        ``contract_partial`` makes (kept modes first). The kernel is timed
        on that view, read in place as the engine hands it over, and on its
        canonical copy, both against the plain version (of the fp32 node
        ``want`` is taken from, for a bf16 one)."""
        fsp = [fs[a] for a in perm[1:-1]]  # fs[a] is the factor of node axis a
        k, rank = len(fsp), node.shape[-1]
        dtype = str(node.dtype).split(".")[-1]
        if want is None:
            want = mttkrp_partial_plain(node.permute(perm), fsp)
        letters = "abcdefg"[:node.ndim - 1]
        spec = f"{letters}z," + ",".join(f"{c}z" for c in letters[1:]) + "->az"
        copy_ms = cuda_ms(lambda: node.permute(perm).contiguous(), reps=3, warm=1) \
            if list(perm) != sorted(perm) else 0.0
        for how in ("in place", "canonical"):
            view = node.permute(perm)
            if how == "canonical":
                view = view.contiguous()
            got = mttkrp_partial(view, fsp)
            rel, diff = check(f"mttkrp_partial {where}, {how}, {dtype}", got, want, dtype)
            ctot = view.numel() // (view.shape[0] * rank)
            b_ms, b_by = bound(view.numel(), view.element_size(), sum(f.numel() for f in fsp),
                               view.shape[0] * rank,
                               2.0 * view.numel() + (k - 1) * ctot * rank, "float32")
            plan = partial_mod.default_plan(view, fsp)
            rows = plan.rows_per_thread(rank)
            times = {
                "kernel": lambda: mttkrp_partial(view, fsp),
                "plain": lambda: mttkrp_partial_plain(view, fsp),
                "library": lambda: torch.einsum(spec, view, *fsp),
            }
            dev = {name: graph_ms(fn, reps=20, rounds=3) for name, fn in times.items()}
            host = {name: cuda_ms(fn, reps=10 if name == "kernel" else 3,
                                  warm=2 if name == "kernel" else 1)
                    for name, fn in times.items()}
            rec = {
                "kernel": "mttkrp_partial", "where": where, "view": how,
                "shape": list(view.shape), "strides": list(view.stride()), "k": k,
                "rank": rank, "dtype": dtype, "max_rel_err": rel, "max_abs_err": diff,
                "plan": {"layout": plan.layout, "block_rows": plan.block_rows, "vec": plan.vec,
                         "loads": plan.loads, "splits": plan.splits},
                "smem_bytes": partial_mod.smem_bytes(plan, view.dtype, rank),
                "registers": PARTIAL_REGS.get(
                    (dtype, plan.vec, plan.layout == "rows", rows)),
                # device time by CUDA graphs (the 4 MB leaves run for a few
                # microseconds, under the host's call rate); host_ms beside
                "timing": "cuda_graph", "graph_ms": dev, "host_ms": host,
                "kernel_ms": dev["kernel"], "plain_ms": dev["plain"],
                "library": "torch.einsum", "library_ms": dev["library"],
                # the canonical copy the engine made in front of the kernel
                # before it read nodes in place
                "transpose_ms": copy_ms, "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
            }
            emit(rec)
            records.setdefault("mttkrp_partial", []).append(rec)
            del view, got

    # fused_pair and the partial kernel at 1000^3, R=64
    dims, rank = (1000, 1000, 1000), 64
    x = torch.randn(dims, generator=gen, device="cuda")
    fs = [torch.randn((d, rank), generator=gen, device="cuda") / rank ** 0.5 for d in dims]
    want = fused_pair_plain(x, fs[1:])
    pair(x, fs, "float32", want)
    xb, fsb = x.to(torch.bfloat16), [f.to(torch.bfloat16) for f in fs]
    pair(xb, fsb, "bfloat16", want)  # bf16 inputs against the fp32 plain version
    del xb, fsb
    p = want[1]  # (I0, I1, R): the fused sweep's P, mode 1 keeps axis 1
    partial(p, [fs[0], fs[1]], (1, 0, 2), "fused 3-way mode 1: P(I0, I1, R), k=1")
    # the dimension tree's right node (I1, I2, R) with its two leaves
    node = ops.mttkrp_canonical(x.permute(1, 2, 0).reshape(-1, dims[0]), fs[:1]).reshape(
        dims[1], dims[2], rank)
    partial(node, [fs[1], fs[2]], (0, 1, 2), "dimtree 3-way leaf 1: (I1, I2, R), k=1")
    partial(node, [fs[1], fs[2]], (1, 0, 2), "dimtree 3-way leaf 2: (I1, I2, R), k=1")
    del want, p, node
    # the dimension tree's 2-D edge: X as an (I1 I2, I0) matrix, one contraction axis
    x2 = x.permute(1, 2, 0).reshape(-1, dims[0]).contiguous()
    got = mttkrpn(x2, fs[:1])
    rel, diff = check("mttkrpn 2-D edge", got, mttkrpn_plain(x2, fs[:1]), "float32")
    b_ms, b_by = mma_bound(x.numel(), 4, fs[0].numel(), x2.shape[0] * rank,
                           2.0 * x.numel() * rank, "float32")
    rec = {
        "kernel": "mttkrpn", "where": "dimtree 3-way root right edge, one contraction axis",
        "shape": list(x2.shape), "rank": rank, "dtype": "float32",
        **mttkrp_launch(x2, rank, False), "max_rel_err": rel,
        "max_abs_err": diff, "kernel_ms": cuda_ms(lambda: mttkrpn(x2, fs[:1])),
        "plain_ms": cuda_ms(lambda: mttkrpn_plain(x2, fs[:1]), reps=3, warm=1),
        "library_ms": cuda_ms(lambda: torch.einsum("abc,az->bcz", x, fs[0]), reps=3, warm=1),
        "transpose_ms": cuda_ms(lambda: x.permute(1, 2, 0).contiguous(), reps=3, warm=1),
        "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
    }
    emit(rec)
    records["mttkrpn"].append(rec)
    del x, fs, x2, got
    torch.cuda.empty_cache()

    # fused_pair and the partial kernel (two contraction axes) at 180^4, R=32
    dims, rank = (180, 180, 180, 180), 32
    x = torch.randn(dims, generator=gen, device="cuda")
    fs = [torch.randn((d, rank), generator=gen, device="cuda") / rank ** 0.5 for d in dims]
    want = fused_pair_plain(x, fs[1:])
    pair(x, fs, "float32", want)
    p = want[1]  # (I0, I1, I2, R)
    pb, fsb = p.to(torch.bfloat16), [f.to(torch.bfloat16) for f in fs[:3]]
    for perm, mode in (((1, 0, 2, 3), 1), ((2, 0, 1, 3), 2)):
        where = f"fused 4-way mode {mode}: P(I0, I1, I2, R), k=2"
        want_p = mttkrp_partial_plain(p.permute(perm), [fs[a] for a in perm[1:-1]])
        partial(p, fs[:3], perm, where, want_p)
        # bf16 inputs against the fp32 plain version of the fp32 node
        partial(pb, fsb, perm, where, want_p)
        del want_p
    del want, p, pb, fsb
    # the dimension tree's root edges: mttkrp3 on X seen as (I0 I1, I2, I3)
    # and, after a permute, as (I2 I3, I0, I1); then the k=1 partials on
    # each (180, 180, R) node, both leaves
    for perm, spec in (((0, 1, 2, 3), "abcd,cz,dz->abz"), ((2, 3, 0, 1), "abcd,az,bz->cdz")):
        rows = dims[perm[0]] * dims[perm[1]]
        where = f"dimtree 4-way root edge, X{perm} as ({rows}, {dims[perm[2]]}, {dims[perm[3]]})"
        # contract_partial's canonical copy (none for the identity permute)
        xe = x.permute(perm).reshape(rows, dims[perm[2]], dims[perm[3]]).contiguous()
        a, b = fs[perm[2]], fs[perm[3]]
        got = mttkrp3(xe, a, b)
        rel, diff = check(f"mttkrp3 {where}", got, mttkrp3_plain(xe, a, b), "float32")
        b_ms, b_by = mma_bound(x.numel(), 4, a.numel() + b.numel(), rows * rank,
                               2.0 * x.numel() * rank, "float32")
        rec = {
            "kernel": "mttkrp3", "where": where, "shape": list(xe.shape), "rank": rank,
            "dtype": "float32", "max_rel_err": rel, "max_abs_err": diff,
            **mttkrp_launch(xe, rank, True),
            "kernel_ms": cuda_ms(lambda: mttkrp3(xe, a, b)),
            "plain_ms": cuda_ms(lambda: mttkrp3_plain(xe, a, b), reps=3, warm=1),
            "library_ms": cuda_ms(lambda: torch.einsum(spec, x, a, b), reps=3, warm=1),
            "transpose_ms": cuda_ms(lambda: x.permute(perm).contiguous(), reps=3, warm=1)
            if perm != (0, 1, 2, 3) else 0.0,
            "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
        }
        emit(rec)
        records["mttkrp3"].append(rec)
        node = got.reshape(dims[perm[0]], dims[perm[1]], rank)
        del xe, got
        node_fs = [fs[perm[0]], fs[perm[1]]]
        partial(node, node_fs, (0, 1, 2), f"dimtree 4-way leaf {perm[0]}: (180, 180, R), k=1")
        partial(node, node_fs, (1, 0, 2), f"dimtree 4-way leaf {perm[1]}: (180, 180, R), k=1")
        del node
    del x, fs
    torch.cuda.empty_cache()


def noisy_low_rank(gen, dims, rank, noise=0.1):
    """A CP-rank-``rank`` tensor plus Gaussian noise, made on the card."""
    import torch
    from repro_torch.core.tensor import random_factors, tensor_from_factors

    x = tensor_from_factors(random_factors(gen, dims, rank))
    scale = float(x.std())
    x += noise * scale * torch.randn(dims, generator=gen, device="cuda")
    return x


def cp_phase(gen) -> dict:
    """Phase 6: the main paths, one per schedule, launches counted, against
    the einsum backend and against the per-mode schedule."""
    import torch
    import repro_torch
    from repro_torch.core.tensor import random_factors
    from repro_torch.kernels import ops

    cases = [((1000, 1000, 1000), 64, 10), ((180, 180, 180, 180), 32, 5)]
    data = []
    for dims, rank, iters in cases:
        x = noisy_low_rank(gen, dims, rank)
        init = random_factors(gen, dims, rank)
        data.append((x, init, rank, iters))
    kernels = counters()
    cuda_ctx = repro_torch.ExecutionContext.create("cuda")
    ein_ctx = repro_torch.ExecutionContext.create("einsum")
    # every node contract_partial hands the partial kernel, as it arrives:
    # a view (of the node, not a copy), its rank axis at unit stride, and
    # whether it is strided (read in place through a permute)
    handed = []
    real_partial = ops.mttkrp_partial

    def watched(node, fs, **kw):
        handed.append((node._base is not None, node.stride(-1) == 1, not node.is_contiguous()))
        return real_partial(node, fs, **kw)

    def run(x, init, rank, iters, sweep, ctx):
        # one untimed iteration first: the first call of a process pays
        # one-time set-up (the solver library, lazy kernel loading)
        repro_torch.cp_als(x, rank, 1, init_factors=init, sweep=sweep, ctx=ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.cp_als(x, rank, iters, init_factors=init, sweep=sweep, ctx=ctx)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) / iters * 1e3

    out = {"launches": {k: 0 for k in kernels}, "cp": []}
    for case, (x, init, rank, iters) in enumerate(data):
        per_mode = None
        for sweep in ("per_mode", "fused", "dimtree"):
            for k in kernels.values():
                k.launches = 0
            handed.clear()
            ops.mttkrp_partial = watched
            try:
                res, ms = run(x, init, rank, iters, sweep, cuda_ctx)
            finally:
                ops.mttkrp_partial = real_partial
            launches = {name: k.launches for name, k in kernels.items()}
            if len(handed) != launches["mttkrp_partial"] or not all(
                    view and unit for view, unit, _ in handed):
                raise AssertionError(f"{sweep} {tuple(x.shape)}: a node reached the partial "
                                     f"kernel as a copy: {handed}")
            want = {name: n * (iters + 1) for name, n in PER_ITER[sweep][case].items()}
            if {k: launches[k] for k in COUNTED} != {k: want.get(k, 0) for k in COUNTED}:
                raise AssertionError(f"{sweep} {tuple(x.shape)}: launches {launches}, "
                                     f"expected {want} (splitk_reduce aside)")
            if launches["splitk_reduce"] == 0:
                raise AssertionError(f"{sweep} {tuple(x.shape)}: the split-K reduction never ran")
            for name, n in launches.items():
                out["launches"][name] += n
            ref, ein_ms = run(x, init, rank, iters, sweep, ein_ctx)
            per_mode = per_mode or res
            gap = max(abs(a - b) for a, b in zip(res.fits, ref.fits))
            gap_pm = max(abs(a - b) for a, b in zip(res.fits, per_mode.fits))
            finite = all(bool(torch.isfinite(f).all()) for f in res.factors)
            rose = 0.0 < res.fits[0] < res.final_fit <= 1.0
            if not finite or len(res.fits) != iters or gap > 1e-4 or gap_pm > 1e-4 or not rose:
                raise AssertionError(
                    f"cp_als {sweep} {tuple(x.shape)}: fits {res.fits} vs einsum {ref.fits} "
                    f"(gap {gap:.2e}) vs per_mode {per_mode.fits} (gap {gap_pm:.2e}), "
                    f"finite={finite}"
                )
            rec = {
                "cp_als": list(x.shape), "sweep": sweep, "rank": rank, "iters": iters,
                "fits": res.fits, "einsum_fits": ref.fits, "max_fit_gap": gap,
                "max_fit_gap_vs_per_mode": gap_pm, "iter_ms_cuda": ms, "iter_ms_einsum": ein_ms,
                "launches": launches, "partial_nodes_strided": sum(s for *_, s in handed),
            }
            emit(rec)
            out["cp"].append(rec)
            del res, ref
    del data
    torch.cuda.empty_cache()
    return out


def matrix_phase(gen) -> dict:
    """Phase 6b: CP-ALS on a matrix (``backend="cuda"``): exactly two
    ``mttkrpn`` launches an iteration (one contraction axis each) and no
    other kernel but split-K reductions, fits within 1e-4 of einsum's."""
    import torch
    import repro_torch
    from repro_torch.core.tensor import random_factors

    dims, rank, iters = MATRIX
    x = noisy_low_rank(gen, dims, rank)
    init = random_factors(gen, dims, rank)
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = repro_torch.cp_als(x, rank, iters, init_factors=init,
                             ctx=repro_torch.ExecutionContext.create("cuda"))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    launches = {name: k.launches for name, k in kernels.items()}
    ref = repro_torch.cp_als(x, rank, iters, init_factors=init,
                             ctx=repro_torch.ExecutionContext.create("einsum"))
    gap = max(abs(a - b) for a, b in zip(res.fits, ref.fits))
    want = {name: 2 * iters if name == "mttkrpn" else 0 for name in COUNTED}
    rec = {"cp_als": list(dims), "sweep": "per_mode", "rank": rank, "iters": iters,
           "fits": res.fits, "einsum_fits": ref.fits, "max_fit_gap": gap,
           "iter_ms_cuda": ms, "launches": launches}
    emit(rec)
    if {k: launches[k] for k in COUNTED} != want or gap > 1e-4 or not all(
            math.isfinite(f) for f in res.fits):
        raise AssertionError(f"cp_als on a matrix: {json.dumps(rec)}; expected launches {want}")
    del x, init, res, ref
    torch.cuda.empty_cache()
    return {"launches": launches, "cp": rec}


def mode_by_mode_ops(shape, ranks) -> int:
    """Operations of a kept-mode-first Multi-TTM contracted mode by mode,
    the last axis first: ``sum_d 2 I prod(C[:d]) prod(R[d-1:])``."""
    i, cs = shape[0], shape[1:]
    return sum(2 * i * math.prod(cs[:d]) * math.prod(ranks[d - 1:])
               for d in range(1, len(cs) + 1))


def multi_ttm_phase(gen, smi: str, records: dict) -> None:
    """Phase 7: ``multi_ttm_keep`` against its plain version on every kept
    mode and on the full core, timed beside its bound and ``torch.einsum``
    on the same canonical operands."""
    import torch
    import repro_torch
    from repro_torch.engine.plan import choose_multi_ttm_kernel_blocks, multi_ttm_kernel_grid
    from repro_torch.kernels import multi_ttm as multi_ttm_mod
    from repro_torch.kernels.multi_ttm import multi_ttm_keep, multi_ttm_keep_plain

    ctx = repro_torch.ExecutionContext.create("cuda")
    letters, rank_letters = "abcdefg", "ABCDEFG"

    def measure(x, mats, keep, dtype, plain_cache):
        n = x.ndim
        lead = 0 if keep is None else keep
        perm = (lead,) + tuple(k for k in range(n) if k != lead)
        xp = x.permute(perm).contiguous()
        ms = [mats[k].contiguous() for k in perm[1:]]
        ranks = tuple(m.shape[1] for m in ms)
        ein = [f"{letters[d]}{rank_letters[d]}" for d in range(n)]
        if keep is None:  # the engine's full core: the kernel, then A_0^T Z
            r0 = mats[0].shape[1]

            def run():
                return repro_torch.multi_ttm(x, mats, None, ctx=ctx)

            def plain():
                z = multi_ttm_keep_plain(xp, ms)
                return (mats[0].float().T @ z).reshape((r0,) + ranks)

            spec = letters[:n] + "," + ",".join(ein) + "->" + rank_letters[:n]
            ops_in = (x, *mats)
            out_words = r0 * math.prod(ranks)
            flops = mode_by_mode_ops(xp.shape, ranks) + 2 * x.shape[0] * out_words
        else:
            def run():
                return multi_ttm_keep(xp, ms)

            def plain():
                return multi_ttm_keep_plain(xp, ms)

            spec = letters[:n] + "," + ",".join(ein[1:]) + "->a" + rank_letters[1:n]
            ops_in = (xp, *ms)
            out_words = xp.shape[0] * math.prod(ranks)
            flops = mode_by_mode_ops(xp.shape, ranks)
        if keep not in plain_cache:
            plain_cache[keep] = plain()
        got = run()
        rel, diff = check(f"multi_ttm_keep {tuple(x.shape)} keep={keep} {dtype}", got,
                          plain_cache[keep].reshape(got.shape), dtype)
        del got
        # counted as the tensor cores run them (3xTF32 for fp32), the folds too
        b_ms, b_by = mma_bound(x.numel(), x.element_size(),
                               sum(m.numel() for m in mats if keep is None or m is not mats[keep]),
                               out_words, flops, dtype)
        plan = choose_multi_ttm_kernel_blocks(xp.shape, ranks, x.element_size())
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rec = {
            "kernel": "multi_ttm_keep", "shape": list(x.shape), "ranks": [m.shape[1] for m in mats],
            "mode": "core" if keep is None else keep, "dtype": dtype,
            "where": "repro_torch.multi_ttm(keep=None): kernel + A_0^T Z" if keep is None
            else "kernel on the kept-mode-first copy",
            "plan": [plan.block_m, plan.block_k, plan.block_r, plan.stages],
            "smem_bytes": multi_ttm_mod.smem_bytes(plan, x.dtype, ranks),
            "splits": multi_ttm_kernel_grid(xp.shape, ranks, plan, sms)[2],
            "registers": RING_REGS.get(("multi_ttm_keep", dtype, plan.block_m, plan.block_r)),
            "max_rel_err": rel, "max_abs_err": diff,
            "kernel_ms": cuda_ms(run),
            "plain_ms": cuda_ms(plain, reps=3, warm=1),
            "library": "torch.einsum", "library_ms": cuda_ms(
                lambda: torch.einsum(spec, *ops_in), reps=3, warm=1),
            "transpose_ms": cuda_ms(lambda: x.permute(perm).contiguous(), reps=3, warm=1)
            if lead else 0.0,
            "mode_by_mode_flops": flops,
            "kronecker_flops": 2 * xp.numel() * math.prod(ranks) if keep is not None else None,
            "bound_ms": b_ms, "bound_by": b_by, "gpu": smi,
        }
        emit(rec)
        records.setdefault("multi_ttm_keep", []).append(rec)
        del xp, ms
        torch.cuda.empty_cache()

    for dims, rank, dtypes in [((1000, 1000, 1000), 32, ("float32", "bfloat16")),
                               ((180, 180, 180, 180), 16, ("float32",))]:
        x = torch.randn(dims, generator=gen, device="cuda")
        mats = [torch.randn((d, rank), generator=gen, device="cuda") / d ** 0.5 for d in dims]
        plain_cache: dict = {}
        for dtype in dtypes:
            # bf16 inputs against the fp32 plain version of the fp32 data
            xd = x if dtype == "float32" else x.to(torch.bfloat16)
            md = mats if dtype == "float32" else [m.to(torch.bfloat16) for m in mats]
            for keep in (*range(len(dims)), None):
                measure(xd, md, keep, dtype, plain_cache)
            del xd, md
        del x, mats, plain_cache
        torch.cuda.empty_cache()


def noisy_tucker(gen, dims, ranks, noise=0.1):
    """A multilinear-rank-``ranks`` tensor plus Gaussian noise, on the card."""
    import torch
    from repro_torch.core.tensor import random_tucker_tensor

    x, _, _ = random_tucker_tensor(gen, dims, ranks)
    x += noise * float(x.std()) * torch.randn(dims, generator=gen, device="cuda")
    return x


def subspace_fit(x64, nx2: float, factors) -> float:
    """The fit of the factors' column spaces, in float64: each factor made
    orthonormal by a float64 QR, X projected onto them in float64 (the
    contiguous last mode first), ``1 - sqrt(||X||^2 - ||P X||^2) / ||X||``.
    The fp32 fit's rounding (of ``||X||^2``, of ``G`` and of the factors'
    orthonormality) drops out; what is left is the subspaces HOOI chose."""
    import torch

    g = x64
    for k in range(len(factors) - 1, -1, -1):
        q, _ = torch.linalg.qr(factors[k].double())
        g = torch.tensordot(g, q, dims=([k], [0])).movedim(-1, k)
    return 1.0 - math.sqrt(max(nx2 - float(g.pow(2).sum()), 0.0) / nx2)


def col_norm_sq_excess(factors) -> list:
    """Per factor, the mean of ``diag(A^T A) - 1``: how far the fp32
    eigenvectors' squared column norms sit above 1."""
    return [float((a.double().pow(2).sum(0) - 1.0).mean()) for a in factors]


def core_fit64(nx2: float, core) -> float:
    """The fit of a committed fp32 core with both squared norms summed in
    float64 (``nx2`` is float64's ``||X||^2``)."""
    return 1.0 - math.sqrt(max(nx2 - float(core.double().pow(2).sum()), 0.0) / nx2)


def tucker_run(gen, dims, ranks, sweeps: int = 5) -> dict:
    """One Tucker shape of phase 8, measured: HOOI on cuda and on einsum
    from the same HOSVD factors (one untimed sweep, then ``sweeps`` timed,
    launches counted from 0), one ``n_iters=0`` call, and the same
    trajectory again one sweep a call, with each sweep's float64 fits."""
    import torch
    import repro_torch
    from repro_torch.core.tensor import frob_norm
    from repro_torch.core.tucker import hosvd_init

    kernels = counters()
    x = noisy_tucker(gen, dims, ranks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init = hosvd_init(x, ranks)
    torch.cuda.synchronize()
    hosvd_ms = (time.perf_counter() - t0) * 1e3
    rec = {"tucker_hooi": list(dims), "ranks": list(ranks), "sweeps": sweeps,
           "hosvd_init_ms": hosvd_ms}
    for backend in ("cuda", "einsum"):
        ctx = repro_torch.ExecutionContext.create(backend)
        for k in kernels.values():
            k.launches = 0
        repro_torch.tucker_hooi(x, ranks, 1, init_factors=init, ctx=ctx)  # untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.tucker_hooi(x, ranks, sweeps, init_factors=init, ctx=ctx)
        torch.cuda.synchronize()
        rec[f"sweep_ms_{backend}"] = (time.perf_counter() - t0) / sweeps * 1e3
        rec[f"launches_{backend}"] = {name: k.launches for name, k in kernels.items()}
        rec[f"fits_{backend}"] = res.fits
        rec[f"factors_{backend}"] = res.factors
    for k in kernels.values():
        k.launches = 0
    hosvd = repro_torch.tucker_hooi(x, ranks, 0, init_factors=init,
                                    ctx=repro_torch.ExecutionContext.create("cuda"))
    rec["launches_hosvd_only"] = {name: k.launches for name, k in kernels.items()}
    rec["hosvd_only_core_shape"] = list(hosvd.core.shape)
    # float64 readings: ||X||^2 both ways, then per sweep the fit of each
    # committed core from float64 sums and the fit of the factors' subspaces
    nx2 = float(torch.linalg.vector_norm(x, dtype=torch.float64)) ** 2
    rec["norm_x_sq_rel_err_fp32"] = float(frob_norm(x)) ** 2 / nx2 - 1.0
    x64 = x.double()
    rec["hosvd_only_fit"] = hosvd.fits[0]
    rec["hosvd_only_fit_core64"] = core_fit64(nx2, hosvd.core)
    rec["hosvd_subspace_fit64"] = subspace_fit(x64, nx2, init)
    rec["col_norm_sq_excess_hosvd"] = col_norm_sq_excess(init)
    for backend in ("cuda", "einsum"):
        ctx = repro_torch.ExecutionContext.create(backend)
        factors, fits, core64, sub64 = init, [], [], []
        for _ in range(sweeps):
            step = repro_torch.tucker_hooi(x, ranks, 1, init_factors=factors, ctx=ctx)
            factors = step.factors
            fits.append(step.fits[0])
            core64.append(core_fit64(nx2, step.core))
            sub64.append(subspace_fit(x64, nx2, factors))
        rec[f"stepwise_fits_{backend}"] = fits
        rec[f"stepwise_same_as_timed_{backend}"] = fits == rec[f"fits_{backend}"]
        rec[f"fits_core64_{backend}"] = core64
        rec[f"subspace_fits64_{backend}"] = sub64
    del x, x64, init, hosvd
    torch.cuda.empty_cache()
    return rec


def check_tucker(rec: dict) -> dict:
    """Phase 8's checks on one shape's readings; returns the line to print.

    The fp32 fits (what ``tucker_hooi`` reports) are finite, within
    ``FIT_NOISE`` of einsum's and fall by at most ``FIT_DROP`` a sweep. The
    float64 fits of the factors' subspaces are held to ``SUBSPACE_TOL``:
    non-decreasing from the HOSVD subspace through every sweep, and equal
    on the two backends."""
    import torch
    from repro_torch.engine.plan import choose_multi_ttm_kernel_blocks, multi_ttm_kernel_grid

    n, sweeps = len(rec["ranks"]), rec["sweeps"]
    want = n * (sweeps + 1)
    # one split-K reduction for each mode whose Multi-TTM the kernel's grid splits
    dims, ranks = rec["tucker_hooi"], rec["ranks"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_modes = 0
    for keep in range(n):
        canon = [dims[keep]] + [d for j, d in enumerate(dims) if j != keep]
        rk = [r for j, r in enumerate(ranks) if j != keep]
        plan = choose_multi_ttm_kernel_blocks(canon, rk, 4)
        split_modes += multi_ttm_kernel_grid(canon, rk, plan, sms)[2] > 1
    for backend, n_launch, n_reduce in (("cuda", want, split_modes * (sweeps + 1)),
                                        ("einsum", 0, 0)):
        got = rec[f"launches_{backend}"]
        if got["multi_ttm_keep"] != n_launch or got["splitk_reduce"] != n_reduce:
            raise AssertionError(f"tucker_hooi {backend} {rec['tucker_hooi']}: launches {got}, "
                                 f"expected {n_launch} multi_ttm_keep, {n_reduce} split-K")
    if (rec["launches_hosvd_only"]["multi_ttm_keep"] != 1
            or rec["hosvd_only_core_shape"] != rec["ranks"]):
        raise AssertionError(f"tucker_hooi n_iters=0 {rec['tucker_hooi']}: "
                             f"{rec['launches_hosvd_only']} launches")
    fits, ref = rec["fits_cuda"], rec["fits_einsum"]
    a_cuda, a_ein = rec.pop("factors_cuda"), rec.pop("factors_einsum")
    gap = max(abs(a - b) for a, b in zip(fits, ref))
    drop = max([0.0] + [a - b for run in (fits, ref) for a, b in zip(run, run[1:])])
    ortho = max(float((a.T @ a - torch.eye(a.shape[1], device="cuda")).abs().max())
                for a in a_cuda)
    cosines = [float(torch.linalg.svdvals(a.T @ b).min()) for a, b in zip(a_cuda, a_ein)]
    sub = {b: [rec["hosvd_subspace_fit64"]] + rec[f"subspace_fits64_{b}"]
           for b in ("cuda", "einsum")}
    sub_drop = max([0.0] + [a - b for run in sub.values() for a, b in zip(run, run[1:])])
    sub_gap = max(abs(a - b) for a, b in zip(sub["cuda"], sub["einsum"]))
    rec.update({"max_fit_gap": gap, "max_fit_drop": drop, "max_orthonormality_err": ortho,
                "col_norm_sq_excess_cuda": col_norm_sq_excess(a_cuda),
                "min_subspace_cosine": min(cosines), "max_subspace_fit64_drop": sub_drop,
                "max_subspace_fit64_gap": sub_gap})
    if (len(fits) != sweeps or not all(math.isfinite(f) for f in fits + ref) or drop > FIT_DROP
            or gap > FIT_NOISE or ortho > 1e-4 or min(cosines) < 0.9999
            or sub_drop > SUBSPACE_TOL or sub_gap > SUBSPACE_TOL):
        raise AssertionError(f"tucker_hooi {rec['tucker_hooi']}: {json.dumps(rec)}")
    return rec


def tucker_phase(gen) -> dict:
    """Phase 8: the Tucker path at both shapes, measured and checked."""
    out = {"launches": {k: 0 for k in KERNELS}, "tucker": []}
    for dims, ranks in [((1000, 1000, 1000), (32, 32, 32)), ((180, 180, 180, 180), (16,) * 4)]:
        rec = check_tucker(tucker_run(gen, dims, ranks))
        for counted in (rec["launches_cuda"], rec["launches_hosvd_only"]):
            for name, n in counted.items():
                out["launches"][name] += n
        emit(rec)
        out["tucker"].append(rec)
    return out


#: The limit on the bf16 mix's reading on :func:`ssd_cancelling` operands:
#: above the sound kernel's (its bf16 output's own rounding, about 2^-9) and
#: far below the bf16-once control's (the weights' own rounding, 2^-9, about
#: as large as the pair differences it reads).
LO_TOL = 1e-2


def ssd_cancelling(gen, bcn: int, q: int, n: int, h: int, p: int, device: str = "cuda"):
    """SSD operands (x bf16) on which rounding the weights to bf16 once
    shows in the bf16 output: every row of C and B the same (one Gram value
    for every pair i, j), no decay, X_{2k+1} = -X_{2k}, and dt_{2k} =
    dt_{2k+1} (1 + e_k) with e_k in [2^-8, 2^-7). An odd row i then sums
    (w_{i,2k} - w_{i,2k+1}) X_{2k}, differences of 2^-8 to 2^-7 of the
    weights: weights held to 2^-9 (bf16) get them about half wrong, hi + lo
    (about 2^-17) right. ``q`` is even."""
    import torch

    v = torch.randn((n,), generator=gen, device=device) / n ** 0.5
    cc = v.expand(bcn, q, n).contiguous()
    d = 0.5 + torch.rand((bcn, q // 2, h), generator=gen, device=device)
    e = 2.0 ** -8 * (1.0 + torch.rand((bcn, q // 2, h), generator=gen, device=device))
    dt = torch.stack((d * (1.0 + e), d), 2).reshape(bcn, q, h)
    xe = torch.randn((bcn, q // 2, h, p), generator=gen, device=device).to(torch.bfloat16)
    x = torch.stack((xe, -xe), 2).reshape(bcn, q, h, p)
    return cc, cc.clone(), torch.zeros((bcn, q, h), device=device), dt, x


def ssd_lo_readings(args, got) -> tuple[float, float]:
    """On :func:`ssd_cancelling` operands: max|d|/max|ref| over the odd rows
    of ``got``, and of the control (the weights rounded to bf16 once, the
    products summed in fp32), against the fp32 sums of the same operands."""
    import torch
    from repro_torch.kernels.ssd_intra import ssd_intra_plain

    cc, bc, cum, dt, x = args
    ref = ssd_intra_plain(cc, bc, cum, dt, x.float())[:, 1::2]
    q = cc.shape[1]
    g = torch.einsum("bin,bjn->bij", cc, bc)
    causal = torch.ones((q, q), dtype=torch.bool, device=cc.device).tril()
    w = torch.where(causal[None, :, :, None],
                    g[..., None] * torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
    once = torch.einsum("bijh,bjhp->bihp", (w * dt[:, None]).to(torch.bfloat16).float(),
                        x.float())[:, 1::2]
    return rel_err(got[:, 1::2], ref)[0], rel_err(once, ref)[0]


def ssd_kernel_phase(gen, smi: str, records: dict, shape: dict = SSD_SHAPE,
                     cell: str = "mamba2-2.7b") -> None:
    """Phase 9a: ``ssd_intra`` against its plain version at the served shape,
    in the model's dtype mix (x bf16, the rest fp32) and in fp32; in the
    bf16 mix also on :func:`ssd_cancelling` operands, against the limit
    that a kernel with bf16 weights would exceed. Phase 9e: the same at
    another ``cell``'s shape, without the cancelling operands; its rows
    are not the kernel's main row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_intra import kernel_plan, smem_bytes, ssd_intra, ssd_intra_plain

    served = shape is SSD_SHAPE
    bcn, q, n, h, p = (shape[k] for k in ("bcn", "q", "n", "h", "p"))
    cc = torch.randn((bcn, q, n), generator=gen, device="cuda")
    bc = torch.randn((bcn, q, n), generator=gen, device="cuda")
    cum = -torch.cumsum(F.softplus(torch.randn((bcn, q, h), generator=gen, device="cuda")), 1)
    dt = F.softplus(torch.randn((bcn, q, h), generator=gen, device="cuda"))
    x32 = torch.randn((bcn, q, h, p), generator=gen, device="cuda")
    for mix, x, tol in (("x_bf16", x32.to(torch.bfloat16), 1e-2), ("f32", x32, 1e-5)):
        args = (cc, bc, cum, dt, x)
        plan = kernel_plan(q, h, p, x.element_size(), bcn=bcn,
                           sms=torch.cuda.get_device_properties(0).multi_processor_count)
        got, want = ssd_intra(*args), ssd_intra_plain(*args)
        if got.shape != want.shape or got.dtype != x.dtype or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ssd_intra {mix}: {tuple(got.shape)} {got.dtype}, or non-finite")
        rel, diff = rel_err(got, want)
        if rel > tol:
            raise AssertionError(f"ssd_intra {mix}: max|d|/max|plain| = {rel:.3e} > {tol}")
        b_ms, b_by = ssd_bound(bcn, q, n, h, p, x.element_size())
        lo = {}
        if served and mix == "x_bf16":  # the weights stay fp32: the lo product is there
            lo_args = ssd_cancelling(gen, bcn, q, n, h, p)
            reading, control = ssd_lo_readings(lo_args, ssd_intra(*lo_args))
            if not reading <= LO_TOL < control:
                raise AssertionError(f"ssd_intra: cancelling operands read {reading:.3e}, the "
                                     f"bf16-once control {control:.3e}, limit {LO_TOL}")
            lo = {"lo_check": {"reading": reading, "bf16_once": control, "limit": LO_TOL}}
            del lo_args
        rec = {
            "kernel": "ssd_intra", "cell": cell, "shape": [bcn, q, n, h, p], "mix": mix,
            "dtype": "bfloat16" if mix == "x_bf16" else "float32",
            "main": served and mix == "x_bf16",
            "plan": list(plan), "smem_bytes": smem_bytes(q, p, plan.tile, x.element_size()),
            "max_rel_err": rel, "max_abs_err": diff, "tol": tol,
            "kernel_ms": cuda_ms(lambda: ssd_intra(*args)),
            "plain_ms": cuda_ms(lambda: ssd_intra_plain(*args), reps=3, warm=1),
            "library": "none: no single PyTorch call computes this function",
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, **lo, "gpu": smi,
        }
        emit(rec)
        records.setdefault("ssd_intra", []).append(rec)
        del got, want
    del cc, bc, cum, dt, x32
    torch.cuda.empty_cache()


def mamba_duality(gen, cfg, length: int = DUAL_LEN) -> dict:
    """Phase 9c: the fp32 model's prefill logits at every position against
    token-by-token ``decode_step`` logits, on one prompt of ``length``
    tokens; returns the readings."""
    import torch
    from repro_torch.models import decode_step, forward, init_decode_state, init_params

    model = init_params(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, length), generator=gen, device="cuda")
    par, _ = forward(model, cfg, {"tokens": tokens}, mode="prefill")
    state = init_decode_state(model, cfg, 1, length)
    steps = []
    for t in range(length):
        lg, state = decode_step(model, cfg, state, tokens[:, t:t + 1])
        steps.append(lg[:, 0])
    seq = torch.stack(steps, dim=1)
    v = cfg.vocab_size
    rel, diff = rel_err(seq[..., :v], par[..., :v])
    per_pos = ((seq[0, :, :v] - par[0, :, :v]).abs().amax(-1)
               / par[0, :, :v].abs().amax()).tolist()
    out = {"duality": cfg.name, "dtype": cfg.dtype, "tokens": length, "chunk": cfg.ssm_chunk,
           "max_rel_err": rel, "max_abs_err": diff, "finite": bool(torch.isfinite(par).all()
                                                               and torch.isfinite(seq).all()),
           "max_rel_err_first_chunk": max(per_pos[:cfg.ssm_chunk]),
           "max_rel_err_later_chunks": max(per_pos[cfg.ssm_chunk:] or [0.0])}
    del model, par, seq, state
    torch.cuda.empty_cache()
    return out


def mamba_phase(gen, smi: str) -> dict:
    """Phase 9b and 9c: Mamba2-2.7b at full width and depth, prefill and
    greedy decode in bf16, then the fp32 duality check."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_decode_state, init_params

    cfg = get_config("mamba2-2.7b")
    kernels = counters()
    model = init_params(cfg, generator=gen)
    n_params = sum(t.numel() for t in model.parameters())
    batch, seq = PREFILL
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen, device="cuda")
    forward(model, cfg, {"tokens": tokens}, mode="prefill", logits_positions="last")  # untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    logits, _ = forward(model, cfg, {"tokens": tokens}, mode="prefill", logits_positions="last")
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: k.launches for name, k in kernels.items()}
    if launches != {name: cfg.n_layers if name == "ssd_intra" else 0 for name in kernels}:
        raise AssertionError(f"mamba2 prefill: launches {launches}, expected "
                             f"{cfg.n_layers} ssd_intra and nothing else")
    if logits.shape != (batch, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"mamba2 prefill: logits {tuple(logits.shape)} or non-finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # greedy decode from the prefill's next tokens; the state starts from
    # zeros (the reference hands no prefill state to decode)
    first = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    warm = init_decode_state(model, cfg, batch, seq + DECODE_STEPS)
    decode_step(model, cfg, warm, first)  # untimed
    state = init_decode_state(model, cfg, batch, seq + DECODE_STEPS)
    tok = first
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_tokens = []
    for _ in range(DECODE_STEPS):
        lg, state = decode_step(model, cfg, state, tok)
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        out_tokens.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    dec_launches = {name: k.launches for name, k in kernels.items()}
    if any(dec_launches.values()) or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"mamba2 decode: launches {dec_launches} (expected none), "
                             f"or non-finite logits")
    rec = {
        "mamba2_serve": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
        "params": n_params, "prompts": batch, "prompt_tokens": seq,
        "prefill_ms": prefill_ms, "prefill_tokens_per_s": batch * seq / prefill_ms * 1e3,
        "prefill_peak_gb": peak_gb, "prefill_launches": launches,
        "decode_steps": DECODE_STEPS, "decode_ms_per_token": decode_ms,
        "decode_tokens_per_s": batch / decode_ms * 1e3,
        "decoded_sample": torch.cat(out_tokens, 1)[0, :8].tolist(), "gpu": smi,
    }
    emit(rec)
    del model, logits, state, warm, lg
    torch.cuda.empty_cache()

    dual = mamba_duality(gen, replace(cfg, dtype="float32"))
    dual["limit"] = DUAL_TOL
    dual["gpu"] = smi
    emit(dual)
    if not dual["finite"] or dual["max_rel_err"] > DUAL_TOL:
        raise AssertionError(f"mamba2 duality: {json.dumps(dual)}")
    return {"launches": launches, "serve": rec, "duality": dual}


def _zeroed(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def _no_launches(kernels, what: str) -> dict:
    launches = {name: k.launches for name, k in kernels.items()}
    if any(launches.values()):
        raise AssertionError(f"{what}: launches {launches}, expected none")
    return launches


@contextlib.contextmanager
def routing_watch():
    """Every MoE layer's ``apply_moe`` call, watched: the list receives each
    call's ``routing_stats`` (choices dropped, the router's smallest margin)
    as tensors on the card."""
    from repro_torch.models import blocks, moe

    seen, real = [], blocks.apply_moe

    def watched(p, x, cfg, *args, **kw):
        seen.append(moe.routing_stats(p, x, cfg))
        return real(p, x, cfg, *args, **kw)

    blocks.apply_moe = watched
    try:
        yield seen
    finally:
        blocks.apply_moe = real


def lm_batch(gen, cfg, batch: int, seq: int) -> dict:
    """A prompt batch: (batch, seq) tokens, or for a config with a stub
    frontend (batch, seq, d_model) embeddings in the model's dtype, the
    frontend's precomputed patch or frame embeddings."""
    import torch
    from repro_torch.models.model import DTYPES

    if cfg.frontend == "none":
        return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                                        device="cuda")}
    return {"embeds": torch.randn((batch, seq, cfg.d_model), generator=gen,
                                  device="cuda").to(DTYPES[cfg.dtype])}


def serve_lm(gen, name: str, layers, smi: str) -> dict:
    """Phases 9d, 9e and 9f for one model in bf16 at full width: prefill, then
    greedy decode; returns the record. A prefill launches ``ssd_intra`` once
    for each SSM layer and nothing else, a decode step nothing. For an MoE
    model the untimed prefill also records what capacity dropped and the
    router's smallest margin (``routing_watch``)."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_decode_state, init_params
    from repro_torch.models.blocks import layer_kind

    full = get_config(name)
    cfg = replace(full, n_layers=layers) if layers else full
    n_ssm = sum(layer_kind(cfg, layer)[0] == "ssm" for layer in range(cfg.n_layers))
    kernels = counters()
    t0 = time.perf_counter()
    model = init_params(cfg, generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.parameters())
    batch, seq = DENSE_PREFILL
    prompt = lm_batch(gen, cfg, batch, seq)
    with routing_watch() as seen:  # untimed
        forward(model, cfg, prompt, mode="prefill", logits_positions="last")
    routing = {}
    if seen:
        routing = {"moe_calls": len(seen),
                   "prefill_dropped": int(sum(int(d) for d, _ in seen)),
                   "min_router_margin": min(float(m) for _, m in seen)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zeroed(kernels)
    t0 = time.perf_counter()
    logits, aux = forward(model, cfg, prompt, mode="prefill", logits_positions="last")
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: n.launches for k, n in kernels.items()}
    expected = {k: n_ssm if k == "ssd_intra" else 0 for k in kernels}
    if launches != expected:
        raise AssertionError(f"{name} prefill: launches {launches}, expected {expected}")
    if logits.shape != (batch, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} prefill: logits {tuple(logits.shape)} or non-finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # greedy decode from the prefill's next tokens; the caches start empty
    # (the reference hands no prefill state to decode)
    first = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    decode_step(model, cfg, init_decode_state(model, cfg, batch, seq), first)  # untimed
    state = init_decode_state(model, cfg, batch, seq)
    tok = first
    _zeroed(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_tokens = []
    for _ in range(DECODE_STEPS):
        lg, state = decode_step(model, cfg, state, tok)
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        out_tokens.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    _no_launches(kernels, f"{name} decode")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{name} decode: non-finite logits")
    kind = "moe_serve" if cfg.n_experts else "vlm_serve" if "embeds" in prompt else "dense_serve"
    rec = {
        kind: name, "dtype": cfg.dtype, "prompt_input": next(iter(prompt)),
        "layers": cfg.n_layers, "of_layers": full.n_layers, "params": n_params,
        "init_s": init_s, "prompts": batch, "prompt_tokens": seq, "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": batch * seq / prefill_ms * 1e3, "prefill_peak_gb": peak_gb,
        "prefill_launches": launches, "logits_shape": list(logits.shape),
        **({"ssm_layers": n_ssm, "moe_aux": float(aux), **routing} if cfg.n_experts else {}),
        "decode_steps": DECODE_STEPS, "decode_cache": seq, "decode_ms_per_token": decode_ms,
        "decode_tokens_per_s": batch / decode_ms * 1e3,
        "decoded_sample": torch.cat(out_tokens, 1)[0, :8].tolist(), "gpu": smi,
    }
    del model, logits, state, lg
    torch.cuda.empty_cache()
    return rec


def dense_duality(gen, smi: str) -> dict:
    """Phase 9d's fp32 check: prefill logits at every position, and
    token-by-token decode logits, against train logits."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_decode_state, init_params

    name, layers, length, steps = DENSE_DUAL
    cfg = replace(get_config(name), n_layers=layers, dtype="float32")
    kernels = counters()
    model = init_params(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, length), generator=gen, device="cuda")
    _zeroed(kernels)
    train, _ = forward(model, cfg, {"tokens": tokens})
    pre, _ = forward(model, cfg, {"tokens": tokens}, mode="prefill")
    state = init_decode_state(model, cfg, 1, steps)
    seq = []
    for t in range(steps):
        lg, state = decode_step(model, cfg, state, tokens[:, t:t + 1])
        seq.append(lg[:, 0])
    launches = _no_launches(kernels, f"{name} duality")
    v = cfg.vocab_size
    ref = train[..., :v]
    pre_rel, pre_diff = rel_err(pre[..., :v], ref)
    dec_rel, dec_diff = rel_err(torch.stack(seq, 1)[..., :v], ref[:, :steps])
    out = {"dense_duality": name, "dtype": cfg.dtype, "layers": layers, "tokens": length,
           "blocks": [length // 1024] * 2, "decode_positions": steps,
           "prefill_max_rel_err": pre_rel, "prefill_max_abs_err": pre_diff,
           "decode_max_rel_err": dec_rel, "decode_max_abs_err": dec_diff,
           "finite": bool(torch.isfinite(train).all() and torch.isfinite(pre).all()
                          and all(bool(torch.isfinite(x).all()) for x in seq)),
           "launches": launches, "limit": DUAL_TOL, "gpu": smi}
    del model, train, pre, state, seq
    torch.cuda.empty_cache()
    return out


def dense_phase(gen, smi: str) -> dict:
    """Phase 9d: the four dense decoders' prefill and decode in bf16, then
    the fp32 duality check. Returns the records."""
    serve = []
    for name, layers in DENSE_LAYERS.items():
        rec = serve_lm(gen, name, layers, smi)
        emit(rec)
        serve.append(rec)
    dual = dense_duality(gen, smi)
    emit(dual)
    if not dual["finite"] or max(dual["prefill_max_rel_err"],
                                 dual["decode_max_rel_err"]) > DUAL_TOL:
        raise AssertionError(f"dense duality: {json.dumps(dual)}")
    return {"serve": serve, "duality": dual}


def moe_plain(p, xf, cfg, r, keep):
    """The MoE layer's plain version on a fixed routing: for each token,
    for each kept choice, the chosen expert's FFN on the token times the
    gate, summed (taken expert by expert: each expert's tokens as one
    matrix; no buffer, no capacity slots)."""
    import torch
    import torch.nn.functional as F

    y = torch.zeros_like(xf)
    for ex in range(cfg.n_experts):
        tok, j = torch.nonzero((r.ids == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = xf[tok]
        h = rows @ p.wi[ex]
        if cfg.act == "silu_glu":
            h = F.silu((rows @ p.wg[ex]).float()).to(h.dtype) * h
        else:
            h = F.relu(h.float()).square().to(h.dtype)
        y.index_add_(0, tok, (h @ p.wo[ex]) * r.gates[tok, j, None].to(h.dtype))
    return y


def earliest_kept(ids, cap: int) -> list:
    """The kept mask, flattened token-major, by counting on the host: a
    choice is kept while fewer than ``cap`` earlier choices chose its
    expert."""
    seen: dict = {}
    kept = []
    for ex in ids.reshape(-1).tolist():
        kept.append(seen.get(ex, 0) < cap)
        seen[ex] = seen.get(ex, 0) + 1
    return kept


def moe_layer_check(gen, name: str, smi: str) -> list:
    """Phase 9e (b): one MoE layer of ``name`` at full width in fp32 on
    ``MOE_TOKENS`` tokens. The routing is taken once and held fixed:
    ``apply_moe(routing=)`` against :func:`moe_plain` on the same gates,
    experts and kept choices, as routed and with the router skewed towards
    expert 0 (its logit raised by about 4) until its queue overflows."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = replace(get_config(name), dtype="float32")
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    p = moe.init_moe(gen, cfg, torch.float32)
    x = torch.randn((1, MOE_TOKENS, d), generator=gen, device="cuda")
    out = []
    for case in ("routed", "skewed"):
        if case == "skewed":
            p.router[:, 0] += 8.0 / d
            x += 0.5
        xf = x.reshape(MOE_TOKENS, d)
        r = moe.route(p, xf, k)
        cap = moe.capacity(MOE_TOKENS, k, e)
        _, keep = moe.assign(r.ids, e, cap)
        got, _ = moe.apply_moe(p, x, cfg, routing=r)
        want = moe_plain(p, xf, cfg, r, keep)
        rel, diff = rel_err(got.reshape(MOE_TOKENS, d), want)
        counts = torch.bincount(r.ids.reshape(-1), minlength=e)
        kept = torch.bincount(r.ids[keep], minlength=e)
        earliest = earliest_kept(r.ids, cap) == keep.reshape(-1).tolist()
        rec = {"moe_layer": name, "case": case, "dtype": "float32", "tokens": MOE_TOKENS,
               "experts": e, "top_k": k, "d_model": d, "moe_d_ff": cfg.moe_d_ff, "cap": cap,
               "max_count": int(counts.max()), "dropped": int((~keep).sum()),
               "kept_is_min_count_cap": bool(torch.equal(kept, counts.clamp_max(cap))),
               "kept_earliest": earliest, "max_rel_err": rel, "max_abs_err": diff,
               "limit": MOE_TOL,
               "moe_ms": cuda_ms(lambda: moe.apply_moe(p, x, cfg, routing=r), reps=3, warm=1),
               "plain_ms": cuda_ms(lambda: moe_plain(p, xf, cfg, r, keep), reps=3, warm=1),
               "gpu": smi}
        emit(rec)
        out.append(rec)
        if not bool(torch.isfinite(got).all()) or rel > MOE_TOL:
            raise AssertionError(f"{name} MoE layer ({case}): max|d|/max|plain| = {rel:.3e} "
                                 f"> {MOE_TOL}, or non-finite")
        if not (rec["kept_is_min_count_cap"] and earliest):
            raise AssertionError(f"{name} MoE layer ({case}): kept {kept.tolist()} of "
                                 f"{counts.tolist()} at cap {cap}, earliest {earliest}")
        if case == "skewed" and not int(counts[0]) > cap:
            raise AssertionError(f"{name} MoE layer: the skewed router sends {int(counts[0])} "
                                 f"choices to expert 0, not more than its {cap} slots")
    del p, x
    torch.cuda.empty_cache()
    return out


def moe_phase(gen, smi: str, records: dict) -> dict:
    """Phase 9e: the MoE models and the hybrid served in bf16, each MoE
    layer with its routing held fixed against its plain version, and
    ``ssd_intra`` at jamba's shape. Returns the records and the prefills'
    launches."""
    serve = []
    launches: dict = {}
    for name, layers in MOE_LAYERS.items():
        rec = serve_lm(gen, name, layers, smi)
        emit(rec)
        serve.append(rec)
        for kernel, n in rec["prefill_launches"].items():
            launches[kernel] = launches.get(kernel, 0) + n
    layer = [r for name in MOE_LAYERS for r in moe_layer_check(gen, name, smi)]
    ssd_kernel_phase(gen, smi, records, JAMBA_SSD, "jamba-v0.1-52b")
    return {"serve": serve, "layer": layer, "launches": launches}


def whisper_encode(model, cfg, frames):
    """The encoder as the reference's encoder-decoder decode test runs it:
    unmasked in ``train`` mode, then ``enc_norm``; -> ``cross_kv``."""
    import torch
    from repro_torch.models.blocks import apply_stack
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.model import _encoder_kv

    pos = torch.arange(frames.shape[1], dtype=torch.int32, device="cuda").expand(
        frames.shape[:2])
    with torch.no_grad():
        enc, _ = apply_stack(model.encoder, frames, cfg, pos, causal=False)
        return _encoder_kv(cfg, apply_norm(model.enc_norm, enc))


def whisper_serve(gen, smi: str) -> dict:
    """Phase 9f (b): whisper-tiny in bf16 at full width and depth: the
    encoder on Whisper's 30 s window, one teacher-forced forward, and
    greedy decode with the encoder's ``cross_kv``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_decode_state, init_params

    cfg = get_config("whisper-tiny")
    kernels = counters()
    model = init_params(cfg, generator=gen)
    n_params = sum(t.numel() for t in model.parameters())
    batch, steps_max = DENSE_PREFILL[0], cfg.max_target_len
    frames = lm_batch(gen, cfg, batch, WHISPER_FRAMES)["embeds"]
    dec = torch.randint(0, cfg.vocab_size, (batch, steps_max), generator=gen, device="cuda")
    whisper_encode(model, cfg, frames)  # untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zeroed(kernels)
    t0 = time.perf_counter()
    kv = whisper_encode(model, cfg, frames)
    torch.cuda.synchronize()
    encoder_ms = (time.perf_counter() - t0) * 1e3
    batch_in = {"embeds": frames, "dec_tokens": dec}
    forward(model, cfg, batch_in)  # untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = forward(model, cfg, batch_in)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if logits.shape != (batch, steps_max, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"whisper forward: logits {tuple(logits.shape)} or non-finite")
    start = torch.full((batch, 1), WHISPER_START, dtype=torch.long, device="cuda")
    decode_step(model, cfg, init_decode_state(model, cfg, batch, steps_max), start,
                cross_kv=kv)  # untimed
    state = init_decode_state(model, cfg, batch, steps_max)
    tok = start
    out_tokens = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        lg, state = decode_step(model, cfg, state, tok, cross_kv=kv)
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        out_tokens.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    launches = _no_launches(kernels, "whisper-tiny")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("whisper decode: non-finite logits")
    rec = {"encdec_serve": "whisper-tiny", "dtype": cfg.dtype,
           "layers": [cfg.n_layers, cfg.dec_layers], "params": n_params,
           "param_count": cfg.param_count(), "prompts": batch, "frames": WHISPER_FRAMES,
           "cross_kv_shape": list(kv[0].shape), "encoder_ms": encoder_ms,
           "forward_dec_tokens": steps_max, "forward_ms": forward_ms, "peak_gb": peak_gb,
           "logits_shape": list(logits.shape), "decode_steps": DECODE_STEPS,
           "decode_cache": steps_max, "decode_ms_per_token": decode_ms,
           "decode_tokens_per_s": batch / decode_ms * 1e3,
           "decoded_sample": torch.cat(out_tokens, 1)[0, :8].tolist(), "launches": launches,
           "gpu": smi}
    del model, logits, state, lg, kv
    torch.cuda.empty_cache()
    return rec


def whisper_duality(gen, smi: str) -> dict:
    """Phase 9f (c): whisper-tiny in fp32: teacher-forced ``train`` logits
    on 1500 frames and ``WHISPER_DUAL_TOKENS`` decoder tokens against
    token-by-token ``decode_step(cross_kv=)`` over the same positions."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_decode_state, init_params

    cfg = replace(get_config("whisper-tiny"), dtype="float32")
    kernels = counters()
    model = init_params(cfg, generator=gen)
    batch, n = DENSE_PREFILL[0], WHISPER_DUAL_TOKENS
    frames = lm_batch(gen, cfg, batch, WHISPER_FRAMES)["embeds"]
    dec = torch.randint(0, cfg.vocab_size, (batch, n), generator=gen, device="cuda")
    _zeroed(kernels)
    train, _ = forward(model, cfg, {"embeds": frames, "dec_tokens": dec})
    kv = whisper_encode(model, cfg, frames)
    state = init_decode_state(model, cfg, batch, n)
    seq = []
    for t in range(n):
        lg, state = decode_step(model, cfg, state, dec[:, t:t + 1], cross_kv=kv)
        seq.append(lg[:, 0])
    launches = _no_launches(kernels, "whisper duality")
    v = cfg.vocab_size
    rel, diff = rel_err(torch.stack(seq, 1)[..., :v], train[..., :v])
    out = {"encdec_duality": "whisper-tiny", "dtype": cfg.dtype, "frames": WHISPER_FRAMES,
           "decode_positions": n, "max_rel_err": rel, "max_abs_err": diff,
           "finite": bool(torch.isfinite(train).all()
                          and all(bool(torch.isfinite(x).all()) for x in seq)),
           "launches": launches, "limit": DUAL_TOL, "gpu": smi}
    del model, train, state, seq, kv
    torch.cuda.empty_cache()
    return out


def vlm_encdec_phase(gen, smi: str) -> dict:
    """Phase 9f: qwen2-vl-72b served from patch embeddings, whisper-tiny
    served with its encoder's ``cross_kv``, and the whisper fp32 duality.
    Returns the records."""
    serve = []
    for name, layers in VLM_LAYERS.items():
        rec = serve_lm(gen, name, layers, smi)
        emit(rec)
        serve.append(rec)
    whisper = whisper_serve(gen, smi)
    emit(whisper)
    dual = whisper_duality(gen, smi)
    emit(dual)
    if not dual["finite"] or dual["max_rel_err"] > DUAL_TOL:
        raise AssertionError(f"whisper duality: {json.dumps(dual)}")
    return {"serve": serve, "whisper": whisper, "duality": dual}


def ssd_backward_check(gen, smi: str) -> dict:
    """Phase 9g (a): ``SsdIntra``'s five gradients at ``TRAIN_SSD`` against
    autograd through ``ssd_intra_plain`` on the same inputs and output
    gradient, in the model's mix (x bf16) and in fp32; one kernel launch for
    the forward and backward together; the closed-form backward's device
    time beside the plain version's forward and its autograd."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_intra import ssd_intra, ssd_intra_grads, ssd_intra_plain

    bcn, q, n, h, p = (TRAIN_SSD[k] for k in ("bcn", "q", "n", "h", "p"))
    cc = torch.randn((bcn, q, n), generator=gen, device="cuda")
    bc = torch.randn((bcn, q, n), generator=gen, device="cuda")
    cum = -torch.cumsum(F.softplus(torch.randn((bcn, q, h), generator=gen, device="cuda")), 1)
    dt = F.softplus(torch.randn((bcn, q, h), generator=gen, device="cuda"))
    x32 = torch.randn((bcn, q, h, p), generator=gen, device="cuda")
    dy32 = torch.randn((bcn, q, h, p), generator=gen, device="cuda")
    out = []
    for mix, dtype in (("x_bf16", torch.bfloat16), ("f32", torch.float32)):
        x, dy = x32.to(dtype), dy32.to(dtype)
        leaves = [t.clone().requires_grad_() for t in (cc, bc, cum, dt, x)]
        before = ssd_intra.launches
        got = torch.autograd.grad(ssd_intra(*leaves), leaves, dy)
        launches = ssd_intra.launches - before
        plain = [t.clone().requires_grad_() for t in (cc, bc, cum, dt, x)]
        want = torch.autograd.grad(ssd_intra_plain(*plain), plain, dy)
        errs = {}
        for name, g, w in zip(("dcc", "dbc", "dcum", "ddt", "dx"), got, want):
            if g.dtype != w.dtype or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"ssd_intra backward {mix} {name}: {g.dtype} or non-finite")
            errs[name] = rel_err(g, w)[0]
        if launches != 1 or max(errs.values()) > SSD_GRAD_TOL[mix]:
            raise AssertionError(f"ssd_intra backward {mix}: {launches} launches, errors {errs}, "
                                 f"limit {SSD_GRAD_TOL[mix]}")
        del got, want, plain
        args = (cc, bc, cum, dt, x)

        def plain_fwd_bwd():
            ls = [t.detach().requires_grad_() for t in args]
            return torch.autograd.grad(ssd_intra_plain(*ls), ls, dy)

        rec = {"ssd_intra_backward": mix, "shape": [bcn, q, n, h, p], "launches": launches,
               "max_rel_err": errs, "limit": SSD_GRAD_TOL[mix],
               "backward_ms": cuda_ms(lambda: ssd_intra_grads(*args, dy), reps=3, warm=1),
               "kernel_forward_ms": cuda_ms(lambda: ssd_intra(*args), reps=3, warm=1),
               "plain_forward_ms": cuda_ms(lambda: ssd_intra_plain(*args), reps=3, warm=1),
               "plain_forward_backward_ms": cuda_ms(plain_fwd_bwd, reps=3, warm=1),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "backward_peak_gb": peak_extra_gb(lambda: ssd_intra_grads(*args, dy)),
               "plain_forward_backward_peak_gb": peak_extra_gb(plain_fwd_bwd), "gpu": smi}
        emit(rec)
        out.append(rec)
        torch.cuda.empty_cache()
    del cc, bc, cum, dt, x32, dy32
    torch.cuda.empty_cache()
    return {"records": out}


def _grads(model, cfg, batch) -> tuple[float, dict]:
    import torch
    from repro_torch.models import loss_fn

    leaves = dict(model.named_parameters())
    loss, _ = loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def train_grad_check(gen, smi: str) -> dict:
    """Phase 9g (b): the gradients of ``loss_fn`` through the kernel
    against the same model with ``ssd_intra`` swapped for its plain version
    in ``models.ssm`` (restored after), every leaf within TRAIN_GRAD_TOL of
    its largest gradient; remat ``none``, ``full`` and ``dots`` within
    REMAT_TOL of one another, exactly layers x 1 ``ssd_intra`` launches a
    step without remat and layers x 2 with it; then FIXED_STEPS AdamW steps
    on the fixed batch, the last loss below the first."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_intra import ssd_intra_plain
    from repro_torch.models import init_params, set_trainable
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.optim import adamw_init, linear_warmup
    from repro_torch.training import TrainState, build_train_step

    layers, (batch, seq) = TRAIN_GRAD
    cfg = replace(get_config("mamba2-2.7b"), dtype="float32", n_layers=layers)
    model = set_trainable(init_params(cfg, generator=gen))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen, device="cuda")
    data = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    kernels = counters()
    runs, launches = {}, {}
    for remat in ("none", "full", "dots"):
        _zeroed(kernels)
        runs[remat] = _grads(model, replace(cfg, remat=remat), data)
        launches[remat] = {name: k.launches for name, k in kernels.items()}
        want = {name: (layers if remat == "none" else 2 * layers) if name == "ssd_intra" else 0
                for name in kernels}
        if launches[remat] != want:
            raise AssertionError(f"train step, remat {remat}: launches {launches[remat]}, "
                                 f"expected {want}")
    real = ssm_mod.ssd_intra
    ssm_mod.ssd_intra = ssd_intra_plain
    try:
        plain = _grads(model, replace(cfg, remat="none"), data)
    finally:
        ssm_mod.ssd_intra = real
    loss, grads = runs["none"]
    errs = {k: rel_err(g, plain[1][k])[0] for k, g in grads.items()}
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    remat = {}
    for mode in ("full", "dots"):
        remat[mode] = {
            "max_rel_err": max(rel_err(g, grads[k])[0] for k, g in runs[mode][1].items()),
            "bit_equal": all(torch.equal(g, grads[k]) for k, g in runs[mode][1].items())
            and runs[mode][0] == loss,
        }
    # the AdamW steps on the fixed batch (they update the model in place)
    state = TrainState(model, adamw_init(model), torch.zeros((), dtype=torch.int32,
                                                             device="cuda"))
    step = build_train_step(cfg, lr_fn=lambda s: linear_warmup(s, 1, FIXED_LR))
    losses = []
    _zeroed(kernels)
    for _ in range(FIXED_STEPS):
        state, metrics = step(state, data)
        losses.append(float(metrics["loss"]))
    launches["fixed_batch_steps"] = {name: k.launches for name, k in kernels.items()}
    rec = {"train_grad_check": cfg.name, "dtype": cfg.dtype, "layers": layers,
           "tokens": [batch, seq], "loss": loss, "plain_loss": plain[0],
           "loss_rel_err": abs(loss - plain[0]) / abs(plain[0]),
           "max_rel_err": errs[worst], "worst_leaf": worst, "limit": TRAIN_GRAD_TOL,
           "remat": remat, "remat_limit": REMAT_TOL, "launches": launches,
           "fixed_batch_losses": losses, "gpu": smi}
    emit(rec)
    if (not finite or errs[worst] > TRAIN_GRAD_TOL or rec["loss_rel_err"] > TRAIN_GRAD_TOL
            or any(r["max_rel_err"] > REMAT_TOL for r in remat.values())):
        raise AssertionError(f"train gradient check: {json.dumps(rec)}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fixed-batch losses {losses}: not finite, or not falling")
    if launches["fixed_batch_steps"]["ssd_intra"] != FIXED_STEPS * 2 * layers:  # remat full
        raise AssertionError(f"fixed-batch steps: launches {launches['fixed_batch_steps']}")
    total = {name: sum(run[name] for run in launches.values()) for name in kernels}
    del model, state, grads, runs, plain
    torch.cuda.empty_cache()
    return {"record": rec, "launches": total}


def train_full(gen, smi: str) -> dict:
    """Phase 9g (c): ``mamba2-2.7b`` in bf16 at full width and depth,
    ``init_train_state`` on the card, ``build_train_step`` on a fixed
    ``synthetic_batch`` of TRAIN_BATCH: one untimed step, then TRAIN_TIMED
    timed, each with exactly 2 x 64 ``ssd_intra`` launches (remat ``full``)
    and no other counted kernel, a finite loss and gradient norm; then the
    same, one untimed and TRAIN_TIMED timed, on the ``REPRO_SSD_LEAN`` path
    (``models.ssm._LEAN`` set, restored after): its ms and peak GB beside
    the default's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.training import build_train_step, init_train_state

    cfg = get_config("mamba2-2.7b")
    batch, seq = TRAIN_BATCH
    t0 = time.perf_counter()
    state = init_train_state(cfg, generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    data = synthetic_batch(DataConfig(cfg.vocab_size, seq, batch, seed=int(
        torch.randint(0, 2 ** 31 - 1, (), generator=gen, device="cuda"))), 0)
    step = build_train_step(cfg)
    kernels = counters()
    want = {name: 2 * cfg.n_layers if name == "ssd_intra" else 0 for name in kernels}
    total = dict.fromkeys(kernels, 0)

    def steps(state, count):
        """``count`` steps on ``data``, each with its launches checked;
        the state after them and their ms, losses and gradient norms."""
        times, losses, norms = [], [], []
        for _ in range(count):
            _zeroed(kernels)
            t0 = time.perf_counter()
            state, metrics = step(state, data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches = {name: k.launches for name, k in kernels.items()}
            if launches != want:
                raise AssertionError(f"mamba2 train step: launches {launches}, expected {want}")
            for name in kernels:
                total[name] += launches[name]
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        if not all(math.isfinite(v) for v in losses + norms):
            raise AssertionError(f"mamba2 train step: losses {losses}, grad norms {norms}")
        ms = sum(times) / len(times)
        return state, {"step_ms": times, "ms_per_step": ms,
                       "tokens_per_s": batch * seq / ms * 1e3, "losses": losses,
                       "grad_norms": norms}

    state, _ = steps(state, 1)  # untimed
    torch.cuda.reset_peak_memory_stats()
    state, timed = steps(state, TRAIN_TIMED)
    timed["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the same steps on the reference's REPRO_SSD_LEAN path (read at call time)
    lean_was = ssm_mod._LEAN
    ssm_mod._LEAN = True
    try:
        state, _ = steps(state, 1)  # untimed
        torch.cuda.reset_peak_memory_stats()
        state, lean = steps(state, TRAIN_TIMED)
        lean["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        ssm_mod._LEAN = lean_was
    rec = {"mamba2_train": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "params": n_params, "remat": cfg.remat, "batch": [batch, seq],
           "init_s": init_s, **timed, "launches_per_step": want, "lean": lean, "gpu": smi}
    emit(rec)
    del state, data
    torch.cuda.empty_cache()
    return {"record": rec, "launches": total}


def train_entry(smi: str) -> dict:
    """Phase 9g (d): ``python -m repro_torch.launch.train`` (LAUNCHER_ARGS)
    in a subprocess: exit 0, its two lines, ``step_15`` and ``step_20``
    kept; then the same smoke model through ``TrainLoop`` with a failure
    injected at step 6: one restart, step 10 reached, the final parameters
    within LOOP_TOL of an uninterrupted run from the same start."""
    import copy
    import functools
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import list_steps
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.training import LoopConfig, TrainLoop, build_train_step, init_train_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ckpt = os.path.join(tmp, "launcher")
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *LAUNCHER_ARGS,
                               "--ckpt-dir", ckpt], capture_output=True, text=True, env=env,
                              timeout=300)
        launcher_s = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        kept = list_steps(ckpt)
        if (proc.returncode != 0 or len(lines) != 2 or not lines[0].startswith("arch=")
                or not lines[1].startswith("done: 20 steps") or not {15, 20} <= set(kept)):
            raise AssertionError(f"launcher: exit {proc.returncode}, kept {kept}, stdout "
                                 f"{proc.stdout[-2000:]!r}, stderr {proc.stderr[-4000:]!r}")

        cfg = get_smoke("mamba2-2.7b")
        start = init_train_state(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
        step = build_train_step(cfg)
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
        crashed = []

        def fail(s):
            if s == 6 and not crashed:
                crashed.append(s)
                raise RuntimeError("injected node failure")

        def loop(directory):
            return TrainLoop(step, data, LoopConfig(total_steps=10, ckpt_every=5,
                                                    ckpt_dir=os.path.join(tmp, directory)),
                             batch_fn=functools.partial(synthetic_batch, device="cuda"))

        kernels = counters()
        _zeroed(kernels)
        recovered = loop("failed")
        state, stats = recovered.run(copy.deepcopy(start), fail_injector=fail)
        clean, clean_stats = loop("clean").run(copy.deepcopy(start))
        launches = {name: k.launches for name, k in kernels.items()}
        pairs = list(zip(state.params.parameters(), clean.params.parameters()))
        err = max(rel_err(p.detach(), q.detach())[0] for p, q in pairs)
        rec = {"train_entry": cfg.name, "launcher_args": LAUNCHER_ARGS, "launcher_s": launcher_s,
               "launcher_stdout": lines, "kept_steps": kept, "restarts": stats.restarts,
               "steps_done": stats.steps_done, "final_step": int(state.step),
               "max_rel_err_vs_uninterrupted": err, "limit": LOOP_TOL,
               "bit_equal": all(torch.equal(p, q) for p, q in pairs),
               "losses": stats.losses, "clean_losses": clean_stats.losses,
               "launches": launches, "gpu": smi}
        emit(rec)
        if stats.restarts != 1 or int(state.step) != 10 or err > LOOP_TOL:
            raise AssertionError(f"loop recovery: {json.dumps(rec)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"record": rec, "launches": launches}


def train_phase(gen, smi: str) -> dict:
    """Phase 9g: the training path, (a) to (d). Times are printed, none
    asserted. Returns the records and the launches of the model's runs."""
    backward = ssd_backward_check(gen, smi)
    parts = [train_grad_check(gen, smi), train_full(gen, smi), train_entry(smi)]
    launches = {name: sum(part["launches"][name] for part in parts) for name in KERNELS}
    return {"backward": backward, "records": [part["record"] for part in parts],
            "launches": launches}


def mesh_rank(tmp: str, seed: int) -> int:
    """Phase 9h, in a process of its own: a world-size-1 NCCL group on a
    free local port, a ``(1, 1)`` ``("data", "model")`` CUDA mesh, then
    (a)-(d) (counts set to 0 before each run and read after); writes
    ``mesh.json`` into ``tmp``. The process group is closed before it
    returns."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_latest, save_checkpoint
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import forward, init_decode_state, init_params
    from repro_torch.models.sharding import (attention_policy, distribute_tree, full,
                                             make_policy)
    from repro_torch.training import (build_serve_step, build_train_step, init_train_state,
                                      jit_serve_step, jit_train_step, train_state_specs)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    t_start = time.perf_counter()
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        kernels = counters()
        total = dict.fromkeys(kernels, 0)

        def run(fn, want):
            """``fn()`` with the counts from 0; its launches checked against
            ``want`` (by kernel name, the rest 0) and added to the total."""
            _zeroed(kernels)
            out = fn()
            torch.cuda.synchronize()
            got = {name: k.launches for name, k in kernels.items()}
            expect = {name: want.get(name, 0) for name in kernels}
            if got != expect:
                raise AssertionError(f"phase 9h: launches {got}, expected {expect}")
            for name in kernels:
                total[name] += got[name]
            return out

        # (a) mamba2-2.7b at full width and depth, plain then sharded, one seed
        cfg = get_config("mamba2-2.7b")
        sh = make_policy(cfg, mesh)
        batch, seq = TRAIN_BATCH
        data = synthetic_batch(DataConfig(cfg.vocab_size, seq, batch, seed=seed + MESH_SEED), 0)
        per_step = {"ssd_intra": 2 * cfg.n_layers}

        def train(sharded: bool):
            """Two steps from the seed's state (laid out on the mesh first,
            the plain state dropped, where ``sharded``): ms, loss and peak
            GB a step."""
            state = init_train_state(
                cfg, generator=torch.Generator(device="cuda").manual_seed(seed + MESH_SEED))
            if sharded:
                state = distribute_tree(state, train_state_specs(state, cfg, sh), sh)
            step = jit_train_step(cfg, sh, state) if sharded else build_train_step(cfg)
            times, losses, peaks = [], [], []
            for _ in range(2):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, metrics = run(lambda: step(state, data), per_step)
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["loss"]))
                peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            placed = sorted({str(tuple(p.placements)) for p in state.params.parameters()
                             if hasattr(p, "placements")})
            del state, step
            torch.cuda.empty_cache()
            return {"step_ms": times, "losses": losses, "peak_gb": peaks, "placements": placed}

        plain = train(False)
        meshed = train(True)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(meshed["losses"], plain["losses"]))
        a = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [batch, seq],
             "launches_per_step": per_step, "plain": plain, "sharded": meshed,
             "max_rel_loss_err": loss_err, "limit": MESH_TOL}
        if loss_err > MESH_TOL or not meshed["placements"]:
            raise AssertionError(f"phase 9h (a): {json.dumps(a)}")

        # (b) the elastic restore on the smoke model
        scfg = get_smoke("mamba2-2.7b")
        ssh = make_policy(scfg, mesh)
        sdata = synthetic_batch(DataConfig(scfg.vocab_size, 64, 8, seed=seed + MESH_SEED), 1)
        start = init_train_state(
            scfg, generator=torch.Generator(device="cuda").manual_seed(seed + MESH_SEED))
        sstep = build_train_step(scfg)
        smoke_launches = {"ssd_intra": 2 * scfg.n_layers}
        start, _ = run(lambda: sstep(start, sdata), smoke_launches)
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, 1, start)
        _, again = restore_latest(ckpt, start)
        _, cont = run(lambda: sstep(again, sdata), smoke_launches)
        specs = train_state_specs(start, scfg, ssh)
        _, onto = restore_latest(ckpt, start, mesh=mesh, spec_tree=specs)
        laid_out = all(tuple(p.placements) == ssh.placements(specs.params[k])
                       for k, p in onto.params.named_parameters())
        _, sharded = run(lambda: jit_train_step(scfg, ssh, onto)(onto, sdata), smoke_launches)
        b_err = abs(float(sharded["loss"]) - float(cont["loss"])) / abs(float(cont["loss"]))
        b = {"arch": scfg.name, "loss_unsharded": float(cont["loss"]),
             "loss_restored_sharded": float(sharded["loss"]), "rel_err": b_err,
             "limit": RESTORE_TOL, "laid_out": laid_out}
        if b_err > RESTORE_TOL or not laid_out:
            raise AssertionError(f"phase 9h (b): {json.dumps(b)}")
        del start, again, onto
        torch.cuda.empty_cache()

        # (c) qwen2-1.5b, all layers: prefill, then greedy decode, plain and
        # sharded under each attention policy: the (1, 1) mesh's own
        # (head_tp) and the one it takes on the 16x16 mesh (context)
        dcfg = get_config("qwen2-1.5b")
        params = init_params(dcfg, generator=torch.Generator(device="cuda").manual_seed(
            seed + MESH_SEED))
        pb, ps = MESH_PREFILL
        gen = torch.Generator(device="cuda").manual_seed(seed + MESH_SEED)
        prompt = {"tokens": torch.randint(0, dcfg.vocab_size, (pb, ps), generator=gen,
                                          device="cuda")}
        prefilled, _ = run(lambda: forward(params, dcfg, prompt, mode="prefill",
                                           logits_positions="last"), {})
        serve, plain_state = build_serve_step(dcfg), init_decode_state(params, dcfg, pb, ps)
        tok = prefilled[:, -1].argmax(-1, keepdim=True)
        steps, plain_ms = [], []
        for _ in range(MESH_DECODE):
            t0 = time.perf_counter()
            want, plain_state = run(lambda: serve(params, plain_state, tok), {})
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append((tok, want))
            tok = want[:, -1].argmax(-1, keepdim=True)
        del plain_state
        c = {"arch": dcfg.name, "layers": dcfg.n_layers, "prefill": [pb, ps],
             "decode_steps": MESH_DECODE, "limit": MESH_TOL, "plain_ms": plain_ms,
             "policies": []}
        for dsh in (make_policy(dcfg, mesh), dataclasses.replace(
                make_policy(dcfg, mesh), attn=attention_policy(dcfg, 16))):
            got, _ = run(lambda: forward(params, dcfg, prompt, mode="prefill",
                                         logits_positions="last", sh=dsh), {})
            errs = [rel_err(full(got).float(), prefilled.float())[0]]
            mesh_state = init_decode_state(params, dcfg, pb, ps)
            mesh_serve = jit_serve_step(dcfg, dsh, params, mesh_state)
            sharded_ms = []
            for tok, want in steps:
                t0 = time.perf_counter()
                got, mesh_state = run(lambda: mesh_serve(params, mesh_state, tok), {})
                sharded_ms.append((time.perf_counter() - t0) * 1e3)
                errs.append(rel_err(full(got).float(), want.float())[0])
            del mesh_state
            c["policies"].append({"attn_policy": dsh.attn, "max_rel_err": max(errs),
                                  "rel_errs": errs, "sharded_ms": sharded_ms})
            if max(errs) > MESH_TOL or not all(math.isfinite(e) for e in errs):
                raise AssertionError(f"phase 9h (c): {json.dumps(c)}")
        del params
        torch.cuda.empty_cache()

        # (d) olmoe-1b-7b's smoke model in fp32: a train step and greedy
        # decode steps, plain and sharded under each MoE policy
        mcfg = dataclasses.replace(get_smoke("olmoe-1b-7b"), dtype="float32")
        mb, ms = MESH_MOE_BATCH
        gen = torch.Generator(device="cuda").manual_seed(seed + MESH_SEED)
        mdata = {k: torch.randint(0, mcfg.vocab_size, (mb, ms), generator=gen, device="cuda")
                 for k in ("tokens", "labels")}
        mtoks = torch.randint(0, mcfg.vocab_size, (mb, MESH_MOE_DECODE), generator=gen,
                              device="cuda")

        def mstate():
            return init_train_state(
                mcfg, generator=torch.Generator(device="cuda").manual_seed(seed + MESH_SEED))

        _, mwant = run(lambda: build_train_step(mcfg)(mstate(), mdata), {})
        mparams, mserve = mstate().params, build_serve_step(mcfg)
        mplain = init_decode_state(mparams, mcfg, mb, MESH_MOE_DECODE)
        dwant = []
        for i in range(MESH_MOE_DECODE):
            want, mplain = run(lambda: mserve(mparams, mplain, mtoks[:, i:i + 1]), {})
            dwant.append(want)
        d = {"arch": mcfg.name, "dtype": mcfg.dtype, "batch": [mb, ms],
             "decode_steps": MESH_MOE_DECODE, "limit": MESH_TOL, "policies": []}
        for moe in ("expert", "ffn"):
            msh = dataclasses.replace(make_policy(mcfg, mesh), moe=moe)
            state = mstate()
            state = distribute_tree(state, train_state_specs(state, mcfg, msh), msh)
            _, got = run(lambda: jit_train_step(mcfg, msh, state)(state, mdata), {})
            loss_err = abs(float(got["loss"]) - float(mwant["loss"])) / abs(float(mwant["loss"]))
            meshed = init_decode_state(mparams, mcfg, mb, MESH_MOE_DECODE)
            mesh_serve = jit_serve_step(mcfg, msh, mparams, meshed)
            errs = []
            for i in range(MESH_MOE_DECODE):
                got, meshed = run(lambda: mesh_serve(mparams, meshed, mtoks[:, i:i + 1]), {})
                errs.append(rel_err(full(got).float(), dwant[i].float())[0])
            d["policies"].append({"moe_policy": moe, "rel_loss_err": loss_err,
                                  "decode_rel_errs": errs})
            if (max([loss_err, *errs]) > MESH_TOL
                    or not all(math.isfinite(e) for e in [loss_err, *errs])):
                raise AssertionError(f"phase 9h (d): {json.dumps(d)}")
            del state
        rec = {"mesh": str(mesh), "device": torch.cuda.get_device_name(0), "train": a,
               "restore": b, "serve": c, "moe": d, "launches": total,
               "seconds": time.perf_counter() - t_start}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, "mesh.json"), "w") as f:
        json.dump(rec, f)
    return 0


def mesh_phase(seed: int, smi: str, trained: dict) -> dict:
    """Phase 9h: :func:`mesh_rank` in a process of its own (no process
    group opens in this one), loading the libraries phase 2 built (no
    ``nvcc`` on its path); its record printed with phase 9g's full-depth
    step beside it. Returns the record and its launches."""
    import tempfile

    import torch

    torch.cuda.empty_cache()  # the child takes the card: this process keeps only what it holds
    parent_gb = torch.cuda.memory_reserved() / 1e9
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        nvcc_dirs = {os.path.dirname(p) for p in (shutil.which("nvcc"),) if p}
        env = {**os.environ, "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo"),
               "CUDA_HOME": os.path.join(tmp, "no-nvcc"),
               "PATH": os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                                       if d not in nvcc_dirs)}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--mesh-rank", tmp], env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"phase 9h: exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-6000:]}")
        with open(os.path.join(tmp, "mesh.json")) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    full_step = trained["records"][1]
    rec["train"]["phase_9g"] = {"ms_per_step": full_step["ms_per_step"],
                                "peak_gb": full_step["peak_gb"]}
    rec["parent_reserved_gb"] = parent_gb
    rec["gpu"] = smi
    emit({"mesh_layer": rec})
    return {"record": rec, "launches": rec["launches"]}


def batched_phase(gen, smi: str) -> dict:
    """Phase 10: the batched engine, one launch a batched call, each call
    against the kernel's plain version and a loop of B unbatched calls,
    then the batched CP-ALS and HOOI drivers against loops of the
    unbatched drivers. Returns the drivers' launches and the records."""
    import torch
    import repro_torch
    from repro_torch.core.krp import khatri_rao
    from repro_torch.core.tensor import random_factors
    from repro_torch.kernels import ops
    from repro_torch.kernels.mttkrpn import mttkrpn_plain
    from repro_torch.kernels.multi_ttm import multi_ttm_keep_plain
    from repro_torch.kernels.partial import mttkrp_partial_plain

    def mttkrp64(xp, fs):
        """The MTTKRP kernels' plain version (``mttkrpn_plain``: X (B, I, K)
        times the Khatri-Rao product) with its product taken in float64:
        cuBLAS's batched fp32 product sums each element's K (65,536 to
        262,144 here) in one pass and strays from float64 by more than the
        kernel does (each mttkrp record's ``plain_fp32_rel_err``)."""
        w = khatri_rao([f.double() for f in reversed(fs)])
        return xp.double().reshape(xp.shape[0], xp.shape[1], -1) @ w

    kernels = counters()
    ctx = repro_torch.ExecutionContext.create("cuda")
    records = []

    def counted(fn):
        """``fn()``, and the launches it made, by kernel."""
        before = {name: k.launches for name, k in kernels.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, {name: k.launches - before[name] for name, k in kernels.items()
                     if k.launches != before[name]}

    def one_launch(what, launches, kernel):
        extra = {k: n for k, n in launches.items() if k not in (kernel, "splitk_reduce")}
        if launches.get(kernel) != 1 or launches.get("splitk_reduce", 0) > 1 or extra:
            raise AssertionError(f"{what}: launches {launches}, expected one {kernel} and at "
                                 f"most one splitk_reduce")

    def measure(what, kernel, batch, call, loop_call, plain, dtype, bytes_moved, time_it,
                plain32=None):
        """One batched engine call: one launch, against its plain version
        and a loop of B calls (B launches); timed against the loop.
        ``plain32``: the fp32 plain version, whose own distance from
        ``plain`` (taken in float64) is recorded."""
        got, launches = counted(call)
        one_launch(what, launches, kernel)
        # fp32 outputs to 1e-5; the engine returns contract_partial's and
        # multi_ttm's results in the input's dtype, so bf16 ones carry its
        # rounding (TOL["bfloat16"])
        out_tol = "float32" if got.dtype == torch.float32 else "bfloat16"
        want = plain()
        rel, diff = check(what, got, want, out_tol)
        extra = {"plain_fp32_rel_err": rel_err(plain32(), want)[0]} if plain32 else {}
        del want
        loop, loop_launches = counted(loop_call)
        if loop_launches.get(kernel) != batch:
            raise AssertionError(f"{what}: the loop made {loop_launches}, expected {batch}")
        rel_loop, _ = check(f"{what} vs loop", got, loop, out_tol)
        rec = {"batched": what, "kernel": kernel, "batch": batch, "dtype": dtype,
               "launches": launches, "loop_launches": loop_launches, "max_rel_err": rel,
               "max_abs_err": diff, "max_rel_err_vs_loop": rel_loop, **extra, "gpu": smi}
        if time_it:
            b_ms = bytes_moved / H100.hbm_bw * 1e3
            rec.update({
                "batched_ms": cuda_ms(call), "looped_ms": cuda_ms(loop_call, reps=3, warm=1),
                "timing": "cuda_events, back to back: host and device",
                "batched_graph_ms": graph_ms(call, reps=5, rounds=2),
                "looped_graph_ms": graph_ms(loop_call, reps=2, rounds=2),
                "bound_ms": b_ms, "bound_by": "bytes"})
        emit(rec)
        records.append(rec)
        del got, loop

    for batch, dims, rank, dtypes in BATCHES:
        n = len(dims)
        x32 = torch.randn((batch, *dims), generator=gen, device="cuda")
        per32 = [torch.randn((batch, d, rank), generator=gen, device="cuda") / rank ** 0.5
                 for d in dims]
        for dtype in dtypes:
            td = getattr(torch, dtype)
            x, per = x32.to(td), [f.to(td) for f in per32]
            shared = [f[0] for f in per]
            elem_bytes = x.element_size()
            tag = f"{batch}x{'x'.join(map(str, dims))} R={rank} {dtype}"
            kern = "mttkrp3" if n == 3 else "mttkrpn"
            # mttkrp in every mode, per-element and shared factors
            for form, fs in (("per_element", per), ("shared", shared)):
                for mode in range(n):
                    def call(fs=fs, mode=mode):
                        return repro_torch.mttkrp(x, fs, mode, ctx=ctx, out_dtype=torch.float32)

                    def loop_call(fs=fs, mode=mode):
                        return torch.stack([repro_torch.mttkrp(
                            x[b], [f[b] if f.ndim == 3 else f for f in fs], mode, ctx=ctx,
                            out_dtype=torch.float32) for b in range(batch)])

                    def plain(fs=fs, mode=mode):
                        return mttkrp64(*ops.canonicalize(x, fs, mode, batched=True))

                    def plain32(fs=fs, mode=mode):
                        return mttkrpn_plain(*ops.canonicalize(x, fs, mode, batched=True))

                    fbytes = sum(f.numel() for k, f in enumerate(fs) if k != mode) * elem_bytes
                    measure(f"mttkrp {tag} mode {mode} {form}", kern, batch, call, loop_call,
                            plain, dtype, x.numel() * elem_bytes + fbytes
                            + batch * dims[mode] * rank * 4, mode == 0 and form == "per_element",
                            plain32)
            # contract_partial on the sweeps' nodes: the fused sweep's P
            # (rank axis, read in place) and the dimension tree's edges
            if n == 3:
                nodes = [((0, 1), (0,), True), ((0, 1), (1,), True),
                         ((0, 1, 2), (2,), False)]
            else:
                nodes = [((0, 1, 2), (0, 2), True), ((0, 1, 2), (0, 1), True),
                         ((0, 1), (1,), True), ((0, 1, 2, 3), (2, 3), False)]
            for modes, drop, has_rank in nodes:
                if has_rank:
                    node = torch.randn((batch, *(dims[m] for m in modes), rank), generator=gen,
                                       device="cuda").to(td)
                else:
                    node = x
                keep = tuple(m for m in modes if m not in drop)
                pos = {m: i for i, m in enumerate(modes)}
                perm = (0,) + tuple(1 + pos[m] for m in keep + drop)

                def call(node=node, modes=modes, drop=drop, has_rank=has_rank):
                    return repro_torch.contract_partial(node, per, modes, drop, has_rank,
                                                        ctx=ctx)

                def loop_call(node=node, modes=modes, drop=drop, has_rank=has_rank):
                    return torch.stack([repro_torch.contract_partial(
                        node[b], [f[b] for f in per], modes, drop, has_rank, ctx=ctx)
                        for b in range(batch)])

                def plain(node=node, drop=drop, has_rank=has_rank, keep=keep, perm=perm):
                    fs = [per[m] for m in drop]
                    sizes = (batch,) + tuple(dims[m] for m in keep) + (rank,)
                    if has_rank:
                        view = node.permute(perm + (node.ndim - 1,))
                        return mttkrp_partial_plain(view, fs, batched=True).reshape(sizes)
                    xp = node.permute(perm).reshape(
                        (batch, math.prod(dims[m] for m in keep)) + tuple(dims[m] for m in drop))
                    return mttkrp64(xp, fs).reshape(sizes)

                kname = "mttkrp_partial" if has_rank else ("mttkrpn" if len(drop) == 1
                                                           else "mttkrp3")
                nbytes = node.numel() * elem_bytes + batch * math.prod(
                    dims[m] for m in keep) * rank * 4
                measure(f"contract_partial {tag} modes {modes} drop {drop}"
                        f"{' rank' if has_rank else ''}", kname, batch, call, loop_call, plain,
                        dtype, nbytes, has_rank and drop == nodes[0][1])
                del node
            # multi_ttm on every keep and the core, ranks 16
            tr = min(16, rank)
            mats = [f[..., :tr].contiguous() for f in per]
            for keep in (*range(n), None):
                ms = [None if k == keep else m for k, m in enumerate(mats)]

                def call(ms=ms, keep=keep):
                    return repro_torch.multi_ttm(x, ms, keep, ctx=ctx)

                def loop_call(ms=ms, keep=keep):
                    return torch.stack([repro_torch.multi_ttm(
                        x[b], [None if m is None else m[b] for m in ms], keep, ctx=ctx)
                        for b in range(batch)])

                def plain(ms=ms, keep=keep):
                    lead = 0 if keep is None else keep
                    order = (lead,) + tuple(k for k in range(n) if k != lead)
                    xp = x.permute((0,) + tuple(1 + k for k in order))
                    z = multi_ttm_keep_plain(xp, [ms[k] for k in order[1:]], batched=True)
                    ranks = (tr,) * (n - 1)
                    if keep is None:
                        return (ms[0].float().transpose(1, 2) @ z).reshape((batch, tr) + ranks)
                    inv = [order.index(a) for a in range(n)]
                    return z.reshape((batch, dims[lead]) + ranks).permute(
                        (0,) + tuple(1 + i for i in inv))

                nbytes = x.numel() * elem_bytes + batch * dims[0] * tr ** (n - 1) * 4
                measure(f"multi_ttm {tag} keep {keep}", "multi_ttm_keep", batch, call,
                        loop_call, plain, dtype, nbytes, keep == 0)
            del x, per, shared, mats
            torch.cuda.empty_cache()
        del x32, per32
        torch.cuda.empty_cache()

    # the drivers: batched CP-ALS and HOOI against loops of the unbatched ones
    batch, dims, rank, iters, trank, sweeps = BATCHED_DRIVERS
    n = len(dims)
    x = torch.stack([noisy_low_rank(gen, dims, rank) for _ in range(batch)])
    draws = [random_factors(gen, dims, rank) for _ in range(batch)]
    init = [torch.stack(f) for f in zip(*draws)]
    for k in kernels.values():
        k.launches = 0
    repro_torch.cp_als_batched(x, rank, 1, init_factors=init, ctx=ctx)  # untimed, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = repro_torch.cp_als_batched(x, rank, iters, init_factors=init, ctx=ctx)
    torch.cuda.synchronize()
    batched_ms = (time.perf_counter() - t0) / iters * 1e3
    launches = {name: k.launches for name, k in kernels.items()}
    t0 = time.perf_counter()
    loop = [repro_torch.cp_als(x[b], rank, iters, init_factors=[f[b] for f in init], ctx=ctx)
            for b in range(batch)]
    torch.cuda.synchronize()
    looped_ms = (time.perf_counter() - t0) / iters * 1e3
    gap = max(abs(float(h[b]) - loop[b].fits[it]) for it, h in enumerate(res.fit_history)
              for b in range(batch))
    cp_rec = {"cp_als_batched": [batch, *dims], "rank": rank, "iters": iters,
              "fits": [float(f) for f in res.fits], "loop_fits": [r.final_fit for r in loop],
              "max_fit_gap_vs_loop": gap, "iter_ms_batched": batched_ms,
              "iter_ms_looped": looped_ms, "launches": launches, "gpu": smi}
    emit(cp_rec)
    want = {name: (n if name == "mttkrp3" else 0) * (iters + 1) for name in COUNTED}
    if {k: launches[k] for k in COUNTED} != want or launches["splitk_reduce"] > n * (iters + 1):
        raise AssertionError(f"cp_als_batched: launches {launches}, expected {want} and at "
                             f"most one splitk_reduce a call")
    if gap > 1e-4 or not all(0.0 < float(f) <= 1.0 for f in res.fits):
        raise AssertionError(f"cp_als_batched: fits {cp_rec['fits']} against the loop's "
                             f"{cp_rec['loop_fits']} (gap {gap:.2e})")
    driver_launches = dict(launches)
    del res, loop, init, draws, x
    torch.cuda.empty_cache()

    x = torch.stack([noisy_tucker(gen, dims, (trank,) * n) for _ in range(batch)])
    for k in kernels.values():
        k.launches = 0
    repro_torch.tucker_hooi_batched(x, (trank,) * n, 1, ctx=ctx)  # untimed, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = repro_torch.tucker_hooi_batched(x, (trank,) * n, sweeps, ctx=ctx)
    torch.cuda.synchronize()
    batched_ms = (time.perf_counter() - t0) / sweeps * 1e3
    launches = {name: k.launches for name, k in kernels.items()}
    t0 = time.perf_counter()
    loop = [repro_torch.tucker_hooi(x[b], (trank,) * n, sweeps, ctx=ctx) for b in range(batch)]
    torch.cuda.synchronize()
    looped_ms = (time.perf_counter() - t0) / sweeps * 1e3
    gap = max(abs(float(res.fits[b]) - loop[b].final_fit) for b in range(batch))
    tk_rec = {"tucker_hooi_batched": [batch, *dims], "ranks": [trank] * n, "sweeps": sweeps,
              "fits": [float(f) for f in res.fits], "loop_fits": [r.final_fit for r in loop],
              "max_fit_gap_vs_loop": gap, "sweep_ms_batched": batched_ms,
              "sweep_ms_looped": looped_ms, "launches": launches, "gpu": smi}
    emit(tk_rec)
    want = {name: (n if name == "multi_ttm_keep" else 0) * (sweeps + 1) for name in COUNTED}
    if {k: launches[k] for k in COUNTED} != want:
        raise AssertionError(f"tucker_hooi_batched: launches {launches}, expected {want}")
    if gap > FIT_NOISE or not all(0.0 < float(f) <= 1.0 for f in res.fits):
        raise AssertionError(f"tucker_hooi_batched: fits {tk_rec['fits']} against the loop's "
                             f"{tk_rec['loop_fits']} (gap {gap:.2e})")
    for name, k in launches.items():
        driver_launches[name] += k
    del res, loop, x
    torch.cuda.empty_cache()
    return {"launches": driver_launches, "records": records, "cp": cp_rec, "tucker": tk_rec}


def _plan_fields(plan):
    return None if plan is None else [type(plan).__name__, *plan.__dict__.values()]


def cp_dist(a, b) -> tuple[float, float, float]:
    """Two CP results ``(fit, weights, factors)`` apart: |fit gap|, and the
    weights' and the factors' largest difference relative to the second's
    largest magnitude (``rel_err``)."""
    return (abs(a[0] - b[0]), rel_err(a[1], b[1])[0],
            max(rel_err(p, q)[0] for p, q in zip(a[2], b[2])))


def serve_once(cache_dir: str) -> int:
    """The cold or warm start of phase 11, in a process of its own: a
    server whose context builds into and loads from ``cache_dir`` serves
    SERVE_START's bucket; prints one JSON line with the time from the
    server's creation to the first result and the libraries it loaded."""
    t0 = time.perf_counter()
    import torch
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import DecompositionServer

    t_import = time.perf_counter()
    count, (lo, hi), rank, iters = SERVE_START
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = [noisy_low_rank(gen, tuple(torch.randint(lo, hi + 1, (3,), generator=gen,
                                                  device="cuda").tolist()), rank)
          for _ in range(count)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    server = DecompositionServer(
        repro_torch.ExecutionContext.create("cuda", compilation_cache=cache_dir),
        n_iters=iters)
    for i, x in enumerate(xs):
        server.submit(x, rank, request_id=f"s{i}")
    results = server.flush()
    t2 = time.perf_counter()
    emit({"serve_once": cache_dir, "first_result_s": t2 - t1, "import_s": t_import - t0,
          "process_s": t2 - t0, "loaded": {k: str(v) for k, v in build.loaded().items()},
          "fits": [r.fit for r in results.values()]})
    return 0


def serve_phase(gen, smi: str) -> dict:
    """Phase 11: the decomposition server on the batched engine. One flush
    of a mixed queue (two buckets) and one of a 4-way queue: one
    ``cp_als_batched`` call a bucket, N MTTKRP launches an iteration run,
    every request against a direct ``cp_als`` from the same start, the
    flush's requests/s against the loop of direct calls; then the cold and
    the warm start, each in a process of its own on one fresh build
    directory. Returns the flushes' launches and the records."""
    import shutil
    import tempfile

    import torch
    import repro_torch
    from repro_torch.core.tensor import random_factors
    from repro_torch.engine import batch as batch_mod
    from repro_torch.launch.serve import DecompositionServer
    from repro_torch.tune.cache import isolated_cache

    kernels = counters()
    calls = []
    real = batch_mod.cp_als_batched

    def counted(xs, *a, **kw):
        """``cp_als_batched``, with the launches of each call."""
        before = {name: k.launches for name, k in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(xs, *a, **kw)
        torch.cuda.synchronize()
        calls.append({"batch": int(xs.shape[0]), "padded": list(xs.shape[1:]),
                      "seconds": time.perf_counter() - t0,
                      "iters_run": int(res.n_iters.max()),
                      "launches": {name: k.launches - before[name]
                                   for name, k in kernels.items()
                                   if k.launches != before[name]}})
        return res

    out = {"launches": {k: 0 for k in kernels}, "records": []}
    auto = repro_torch.ExecutionContext.create("auto")
    cuda_ctx = repro_torch.ExecutionContext.create("cuda")
    ein_ctx = repro_torch.ExecutionContext.create("einsum")
    with isolated_cache():  # auto on an empty cache: every contraction a miss, cuda
        for label, queue in (("mixed", SERVE_QUEUE), ("4-way", SERVE_4WAY)):
            server = DecompositionServer(auto, n_iters=SERVE_ITERS)
            data = []
            for count, (lo, hi), rank, ways in queue:
                for _ in range(count):
                    shape = tuple(torch.randint(lo, hi + 1, (ways,), generator=gen,
                                                device="cuda").tolist())
                    data.append((noisy_low_rank(gen, shape, rank), rank))

            def submit_all(tag):
                return [(server.submit(x, rank, request_id=f"{label}{tag}{i}"), x, rank)
                        for i, (x, rank) in enumerate(data)]

            # the buckets' first flush, untimed: a server's steady state is
            # what its clients see (cold is the per-process start, below)
            submit_all("warm")
            server.flush()
            reqs = submit_all("")
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            calls.clear()
            batch_mod.cp_als_batched = counted
            try:
                t0 = time.perf_counter()
                results = server.flush()
                flush_s = time.perf_counter() - t0
            finally:
                batch_mod.cp_als_batched = real
            launches = {name: k.launches for name, k in kernels.items()}
            for name, n in launches.items():
                out["launches"][name] += n
            if len({r.bucket for r in results.values()}) != len(queue) or len(calls) != len(
                    queue):
                raise AssertionError(f"serve {label}: {len(calls)} cp_als_batched calls for "
                                     f"{len(queue)} buckets")
            for call, (_, _, _, ways) in zip(calls, queue):
                kern = "mttkrp3" if ways == 3 else "mttkrpn"
                got = {k: n for k, n in call["launches"].items() if k != "splitk_reduce"}
                if got != {kern: ways * call["iters_run"]}:
                    raise AssertionError(f"serve {label}: bucket {call['padded']} launched "
                                         f"{call['launches']}, expected {ways} {kern} an "
                                         f"iteration for {call['iters_run']} iterations")
            # the loop a client would run instead: a direct cp_als a request,
            # from the same start (the server's i-th request is seeded i + 1;
            # the untimed flush took the first len(data) seeds) and for the
            # iterations the server ran it; one untimed call first
            inits = [random_factors(torch.Generator(device="cuda").manual_seed(
                len(data) + i + 1), tuple(x.shape), rank) for i, (_, x, rank) in enumerate(reqs)]
            repro_torch.cp_als(reqs[0][1], reqs[0][2], 1, init_factors=inits[0], ctx=cuda_ctx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            direct = [repro_torch.cp_als(x, rank, results[rid].n_iters, init_factors=init,
                                         ctx=cuda_ctx)
                      for (rid, x, rank), init in zip(reqs, inits)]
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
            # each request against its direct run, and both against the same
            # run in float64: over 10 iterations fp32 ALS can amplify rounding
            # (served and direct runs of one request differed by up to 7.1e-3
            # in factors, PERF.md), so the 1e-4 check holds where the direct
            # run is sound and float64 judges the rest (SERVE_SOUND)
            worst = {"served_vs_direct": [0.0] * 3, "served_vs_float64": [0.0] * 3,
                     "direct_vs_float64": [0.0] * 3}
            beyond, held, per_request, problems = 0, [0, 0, 0], [], []
            for (rid, x, rank), d, init in zip(reqs, direct, inits):
                r = results[rid]
                if [tuple(f.shape) for f in r.factors] != [tuple(f.shape) for f in d.factors]:
                    raise AssertionError(f"serve {rid}: not cropped to {tuple(x.shape)}")
                f64 = repro_torch.cp_als(x.double(), rank, r.n_iters,
                                         init_factors=[f.double() for f in init], ctx=ein_ctx)
                served = (r.fit, r.weights, r.factors)
                dd = (d.final_fit, d.weights, d.factors)
                ff = (f64.final_fit, f64.weights, f64.factors)
                sd, s64, d64 = cp_dist(served, dd), cp_dist(served, ff), cp_dist(dd, ff)
                beyond += any(v > SERVE_TOL for v in sd)
                per_request.append({"id": rid, "shape": list(x.shape), "served_vs_direct": sd,
                                    "served_vs_float64": s64, "direct_vs_float64": d64})
                for name, v in (("served_vs_direct", sd), ("served_vs_float64", s64),
                                ("direct_vs_float64", d64)):
                    worst[name] = [max(a, b) for a, b in zip(worst[name], v)]
                for k, what in enumerate(("fit", "weights", "factors")):
                    if d64[k] <= SERVE_SOUND:
                        held[k] += 1
                        if sd[k] > SERVE_TOL:
                            problems.append(f"{rid}: {what} {sd[k]:.3e} from its direct run "
                                            f"(sound: {d64[k]:.3e} from float64; limit "
                                            f"{SERVE_TOL})")
                    if s64[k] > min(2 * d64[k] + SERVE_TOL, SERVE_CAP[k]):
                        problems.append(f"{rid}: {what} {s64[k]:.3e} from float64, the direct "
                                        f"run {d64[k]:.3e} (limit twice it + {SERVE_TOL}, at "
                                        f"most {SERVE_CAP[k]})")
            # exactness over SERVE_EXACT_ITERS iteration (tol 0): a fresh
            # server (seeds 1..n) against direct runs, fit, weights and
            # factors within 1e-4
            exact = DecompositionServer(auto, n_iters=SERVE_EXACT_ITERS, tol=0.0)
            ids = [(exact.submit(x, rank, request_id=f"{label}exact{i}"), x, rank)
                   for i, (x, rank) in enumerate(data)]
            got = exact.flush()
            exact_gap = [0.0] * 3
            for i, (rid, x, rank) in enumerate(ids):
                init = random_factors(torch.Generator(device="cuda").manual_seed(i + 1),
                                      tuple(x.shape), rank)
                d = repro_torch.cp_als(x, rank, SERVE_EXACT_ITERS, init_factors=init,
                                       ctx=cuda_ctx)
                v = cp_dist((got[rid].fit, got[rid].weights, got[rid].factors),
                         (d.final_fit, d.weights, d.factors))
                exact_gap = [max(a, b) for a, b in zip(exact_gap, v)]
            if max(exact_gap) > SERVE_TOL:
                problems.append(f"after {SERVE_EXACT_ITERS} iterations the served results "
                                f"differ from direct runs by {exact_gap} (fit, weights, "
                                f"factors; limit {SERVE_TOL})")
            del got, exact
            fit_gap, weight_err, factor_err = worst["served_vs_direct"]
            rec = {"serve": label, "requests": len(reqs), "buckets": calls,
                   "flush_s": flush_s, "requests_per_s": len(reqs) / flush_s,
                   "loop_s": loop_s, "loop_requests_per_s": len(reqs) / loop_s,
                   "max_fit_gap": fit_gap, "max_weight_rel_err": weight_err,
                   "max_factor_rel_err": factor_err,
                   "worst_fit_weights_factors": worst, "requests_beyond_1e-4": beyond,
                   "held_to_1e-4_fit_weights_factors": held, "per_request": per_request,
                   "exact_iters": SERVE_EXACT_ITERS, "exact_fit_weights_factors": exact_gap,
                   "converged": sum(r.converged for r in results.values()),
                   "cold": sum(r.cold for r in results.values()),
                   "launches": launches, "gpu": smi}
            emit(rec)
            out["records"].append(rec)
            if problems:
                raise AssertionError(f"serve {label}: " + "; ".join(problems))
            del results, direct, reqs, inits, server, data
            torch.cuda.empty_cache()

    # the cold and the warm start: two processes in turn on one fresh directory
    cache_dir = tempfile.mkdtemp(prefix="repro-torch-serve-")
    try:
        starts = []
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-once",
                                   cache_dir], capture_output=True, text=True)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"serve {run} start failed:\n{proc.stdout}\n{proc.stderr}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec.update({"start": run, "wall_s": wall, "gpu": smi,
                        "libraries": sorted(os.listdir(cache_dir))})
            starts.append(rec)
            emit(rec)
        cold, warm = starts
        lib = cold["loaded"].get("mttkrp.cu", "")
        if os.path.dirname(lib) != os.path.realpath(cache_dir) or warm["loaded"] != cold[
                "loaded"] or not os.path.exists(lib):
            raise AssertionError(f"serve starts: libraries {cold['loaded']} then "
                                 f"{warm['loaded']}, expected mttkrp.cu from {cache_dir}")
        if not warm["first_result_s"] < cold["first_result_s"]:
            raise AssertionError(f"serve starts: warm {warm['first_result_s']:.2f} s is not "
                                 f"faster than cold {cold['first_result_s']:.2f} s")
        out["starts"] = starts
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    return out


def tune_phase(gen, smi: str) -> dict:
    """Phase 12: the four searches at 1000^3 on an isolated cache, every
    candidate recorded; the winner the fastest measured, the chooser's plan
    among the candidates, every key a hit from a fresh ``PlanCache``; then
    CP-ALS on ``auto`` (per_mode, and ``sweep="auto"``) against ``cuda``,
    the host's cost a call on a cache hit against ``cuda``, and the
    calibration. Returns the auto runs' launches and the records."""
    import torch
    import repro_torch
    from repro_torch.core.tensor import random_factors
    from repro_torch.engine.plan import (
        choose_mttkrp_kernel_blocks,
        choose_multi_ttm_kernel_blocks,
        choose_pair_kernel_blocks,
    )
    from repro_torch.kernels import partial as partial_mod
    from repro_torch.tune import cache as tcache
    from repro_torch.tune import search
    from repro_torch.tune.calibrate import calibrate, calibration_report

    kernels = counters()
    auto = repro_torch.ExecutionContext.create("auto")
    cuda_ctx = repro_torch.ExecutionContext.create("cuda")
    dims, rank, trank = TUNE_PROBLEM
    out = {"launches": {k: 0 for k in kernels}, "searches": []}
    with tcache.isolated_cache() as path:
        x = noisy_low_rank(gen, dims, rank)
        fs = random_factors(gen, dims, rank)
        node = repro_torch.contract_partial(x, fs, (0, 1, 2), (2,), False, ctx=cuda_ctx)
        mats = [f[:, :trank].contiguous() for f in fs]
        # the fused sweep's k = 1 edge: P's mode 0 dropped for mode 1's B, the
        # node read in place as the permuted view (I1, I0, R)
        view = node.permute(1, 0, 2)
        searches = [
            ("tune_mttkrp", lambda: search.tune_mttkrp(x, fs, 0, ctx=auto),
             choose_mttkrp_kernel_blocks(dims, rank, 4)),
            ("tune_partial", lambda: search.tune_partial(node, fs, (0, 1), (0,), True,
                                                         ctx=auto),
             partial_mod.default_plan(view, [fs[0]])),
            ("tune_multi_ttm", lambda: search.tune_multi_ttm(x, mats, 0, ctx=auto),
             choose_multi_ttm_kernel_blocks(dims, (trank, trank), 4)),
            ("tune_sweep", lambda: search.tune_sweep(x, rank, ctx=auto, factors=fs),
             choose_pair_kernel_blocks(dims, rank, 4)),
        ]
        keys = []
        for name, run, chooser in searches:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            ok = [m for m in res.measurements if m.ok and math.isfinite(m.walltime_us)]
            fastest = min(ok, key=lambda m: m.walltime_us).candidate
            rec = {"tune": name, "key": res.key, "metric": res.metric, "search_s": took,
                   "winner": res.winner.label, "winner_plan": _plan_fields(res.winner.plan),
                   "chooser_plan": _plan_fields(chooser),
                   "candidates": [{"label": m.candidate.label,
                                   "backend": m.candidate.backend,
                                   "plan": _plan_fields(m.candidate.plan),
                                   "variant": m.candidate.variant, "block": m.candidate.block,
                                   "us": m.walltime_us, "ok": m.ok, "error": m.error}
                                  for m in res.measurements], "gpu": smi}
            emit(rec)
            out["searches"].append(rec)
            if res.cache_hit or res.metric != "walltime" or res.winner != fastest:
                raise AssertionError(f"{name}: winner {res.winner.label} is not the fastest "
                                     f"measured candidate {fastest.label}")
            if chooser not in [m.candidate.plan for m in res.measurements]:
                raise AssertionError(f"{name}: the chooser's plan {chooser} is no candidate")
            keys.append(res.key)
        keys.append(tcache.cache_key(dims, rank, -1, torch.float32, repro_torch.Memory.h100_smem(),
                                     kind="pair"))
        fresh = tcache.PlanCache(path)
        name = torch.cuda.get_device_name(0)
        for key in keys:
            if fresh.get(key) is None or f"|platform={name}|" not in key or (
                    f"|torch={torch.__version__}" not in key):
                raise AssertionError(f"tune: key {key!r} is no hit from a fresh PlanCache on "
                                     f"{path}, or lacks platform={name} / torch=")
        out["keys"] = keys
        del node, mats

        # CP-ALS on auto against cuda, from the same factors
        init = random_factors(gen, dims, rank)
        runs = {}
        for label, ctx, sweep in (("cuda", cuda_ctx, "per_mode"), ("auto", auto, "per_mode"),
                                  ("sweep_auto", auto, "auto")):
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            res = repro_torch.cp_als(x, rank, AUTO_ITERS, init_factors=init, sweep=sweep,
                                     ctx=ctx)
            torch.cuda.synchronize()
            runs[label] = (res, {name: k.launches for name, k in kernels.items()},
                           (time.perf_counter() - t0) / AUTO_ITERS * 1e3)
        for label in ("auto", "sweep_auto"):
            for name, n in runs[label][1].items():
                out["launches"][name] += n
        resolved = {"per_mode": []}
        for m in range(3):
            r = search.resolve((dims[m],) + tuple(d for k, d in enumerate(dims) if k != m),
                               rank, m, torch.float32, device="cuda")
            resolved["per_mode"].append({"mode": m, "backend": r.backend, "variant": r.variant,
                                         "plan": _plan_fields(r.plan), "hit": r.cache_hit})
        r = search.resolve_sweep(dims, rank, torch.float32, device="cuda")
        resolved["sweep"] = {"variant": r.variant, "plan": _plan_fields(r.plan),
                             "hit": r.cache_hit}
        # the launches the resolved decisions call for: an MTTKRP kernel
        # launch a mode an iteration where a mode resolved to cuda; fused,
        # the pair, the partial and mode 2's mttkrp3 once an iteration each
        expected = {"auto": {}}
        for d in resolved["per_mode"]:
            if d["backend"] == "cuda":
                kern = "mttkrpn" if d["variant"] == "generic" else "mttkrp3"
                expected["auto"][kern] = expected["auto"].get(kern, 0) + AUTO_ITERS
        expected["sweep_auto"] = ({k: AUTO_ITERS for k in ("mttkrp3", "fused_pair",
                                                           "mttkrp_partial")}
                                  if r.variant == "fused" else expected["auto"])
        gaps = {label: max(abs(a - b) for a, b in zip(runs[label][0].fits,
                                                      runs["cuda"][0].fits))
                for label in ("auto", "sweep_auto")}
        rec = {"cp_als_auto": list(dims), "rank": rank, "iters": AUTO_ITERS,
               "fits": {k: v[0].fits for k, v in runs.items()},
               "launches": {k: v[1] for k, v in runs.items()},
               "iter_ms": {k: v[2] for k, v in runs.items()},
               "max_fit_gap_vs_cuda": gaps, "resolved": resolved,
               "expected_launches": expected, "gpu": smi}
        emit(rec)
        out["auto"] = rec
        if max(gaps.values()) > 1e-4:
            raise AssertionError(f"cp_als on auto: fits {rec['fits']} (gaps {gaps}, limit 1e-4)")
        for label, want in expected.items():
            got = {k: n for k, n in runs[label][1].items() if n and k != "splitk_reduce"}
            if got != want or not want:
                raise AssertionError(f"cp_als on {label}: launched {got}, the resolved "
                                     f"decisions {resolved} call for {want}")
        del runs, x, fs, init
        torch.cuda.empty_cache()

        # the host's cost a call: auto on a cache hit (the chooser's plan, as
        # cuda runs it) against cuda, interleaved rounds, each at its best
        hdims, hrank, n = HOST_PROBE
        hx = torch.randn(hdims, generator=gen, device="cuda")
        hfs = [torch.randn((d, hrank), generator=gen, device="cuda") for d in hdims]
        key = tcache.cache_key(hdims, hrank, 0, torch.float32, repro_torch.Memory.h100_smem())
        tcache.default_cache().put(key, tcache.CacheEntry("cuda", tcache.plan_to_dict(
            choose_mttkrp_kernel_blocks(hdims, hrank, 4))), persist=False)
        on_path = repro_torch.ExecutionContext.create("auto", cache_path=path)
        probes = (("cuda", cuda_ctx), ("auto", auto), ("auto_cache_path", on_path))
        per_call = {label: float("inf") for label, _ in probes}
        for _ in range(5):
            for label, ctx in probes:
                for _ in range(20):
                    repro_torch.mttkrp(hx, hfs, 0, ctx=ctx)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    repro_torch.mttkrp(hx, hfs, 0, ctx=ctx)
                torch.cuda.synchronize()
                per_call[label] = min(per_call[label], (time.perf_counter() - t0) / n * 1e6)
        if not all(search.resolve(hdims, hrank, 0, torch.float32, device="cuda",
                                  cache=c).cache_hit for c in (None, on_path.plan_cache())):
            raise AssertionError("host probe: the auto calls missed the cache")
        rec = {"host_us_per_call": per_call, "shape": list(hdims), "rank": hrank,
               "lookup_us": per_call["auto"] - per_call["cuda"],
               "cache_path_lookup_us": per_call["auto_cache_path"] - per_call["cuda"],
               "gpu": smi}
        emit(rec)
        out["host"] = rec
        if max(per_call["auto"], per_call["auto_cache_path"]) > 1.3 * per_call["cuda"]:
            raise AssertionError(f"auto's lookup costs the host {per_call} us a call")

        # the calibration, on the card
        cal = calibrate(CALIBRATION, device="cuda")
        print(calibration_report(cal), flush=True)
        out["calibration"] = cal.to_dict()
        emit({"calibration": out["calibration"], "gpu": smi})
    return out


def _dispatch_checks(events, launched, mem) -> list:
    """Phase 13a's checks of each dispatch event: backend ``cuda``, the plan
    its wrapper launched (``launched``: the kernel launches of the same
    runs, in order), ``modeled_words`` the Eq-10 words (or the Multi-TTM
    model's) of the model plan against ``mem``, the bound under the model."""
    from repro_torch.engine.plan import choose_blocks, choose_multi_ttm_blocks, keep_first
    from repro_torch.tune.cache import plan_from_dict

    problems = []
    plans = [k.plan for k in launched if k.plan is not None]
    spans = [e for e in events if e["kind"] in DISPATCH_KINDS]
    if len(plans) != len(spans):
        problems.append(f"{len(spans)} dispatch events for {len(plans)} kernel launches")
    for e, plan in zip(spans, plans):
        if e["backend"] != "cuda" or e["plan"] is None or plan_from_dict(e["plan"]) != plan:
            problems.append(f"{e['kind']} #{e['seq']}: backend {e['backend']}, plan {e['plan']} "
                            f"where the wrapper launched {plan}")
        if e["kind"] == "fused_pair":
            continue
        if e["kind"] == "multi_ttm":
            canon = keep_first(e["shape"], e["keep"] if e["keep"] is not None else 0)
            kranks = e["ranks"][1:] if e["keep"] is None else e["ranks"]
            want = choose_multi_ttm_blocks(canon, kranks, 4, memory=mem).model_words(canon)
        else:
            canon = keep_first(e["shape"], e["mode"]) if e["kind"] == "mttkrp" else e["shape"]
            want = choose_blocks(canon, e["rank"], 4, memory=mem,
                                 x_has_rank=bool(e.get("has_rank"))).eq10_words(canon, e["rank"])
        if e["modeled_words"] != want or not e["lower_bound_words"] <= e["modeled_words"]:
            problems.append(f"{e['kind']} #{e['seq']}: modeled {e['modeled_words']} (the model "
                            f"plan's {want}), bound {e['lower_bound_words']}")
    return problems


def _span_summary(events) -> dict:
    """Per dispatch kind: count, mean host µs, and the model's and the
    kernel's bytes summed."""
    out: dict = {}
    for e in events:
        if e["kind"] not in DISPATCH_KINDS:
            continue
        d = out.setdefault(e["kind"], {"events": 0, "wall_time_us": 0.0, "modeled_bytes": 0,
                                       "kernel_modeled_bytes": 0})
        d["events"] += 1
        d["wall_time_us"] += e["wall_time_us"]
        d["modeled_bytes"] += e.get("modeled_words", 0) * e["itemsize"]
        d["kernel_modeled_bytes"] += e.get("kernel_modeled_bytes", 0)
    for d in out.values():
        d["wall_time_us"] /= d["events"]
    return out


def observe_phase(gen, smi: str) -> dict:
    """Phase 13: the observability layer on the main path. (a) CP-ALS on
    every schedule and HOOI, traced; (b) what a span costs; (c) the spans'
    ranges in the profiler, and nothing recorded during a graph capture;
    (d) the bounds audits; (e) the server's and the tuner's spans and
    counters. Returns the traced runs' launches and the records."""
    import shutil
    import tempfile

    import torch
    import repro_torch
    from repro_torch.core.tensor import random_factors

    kernels = counters()
    plain = repro_torch.ExecutionContext.create("cuda")
    obs = repro_torch.ExecutionContext.create("cuda", observe=True)
    dims, rank, _ = OBSERVE_CP
    x = noisy_low_rank(gen, dims, rank)
    init = random_factors(gen, dims, rank)
    out = {"launches": {k: 0 for k in kernels}, "records": []}
    tmp = tempfile.mkdtemp(prefix="repro-torch-trace-")
    try:
        for k in kernels.values():
            k.launches = 0
        out["records"].append(observe_main_path(x, init, plain, obs, tmp, smi))
        out["launches"] = {name: k.launches for name, k in kernels.items()}
        out["records"].append(observe_span_cost(gen, x, init, plain, obs, smi))
        out["records"].append(observe_profiler(gen, x, init, obs, smi))
        del x
        torch.cuda.empty_cache()
        out["records"].append(observe_audits(gen, plain, tmp, smi))
        out["records"].append(observe_serve_and_tune(gen, smi))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def observe_main_path(x, init, plain, obs, tmp: str, smi: str) -> dict:
    """13a: CP-ALS on every schedule and HOOI with ``observe=True`` in one
    trace, against the same runs untraced."""
    import torch
    import repro_torch
    from repro_torch.core.tucker import hosvd_init
    from repro_torch.engine.plan import Memory
    from repro_torch.observe import Trace, collect, load_trace, registry
    from repro_torch.observe.metrics import CUDA_DISPATCHES

    _, rank, iters = OBSERVE_CP
    trank, sweeps = OBSERVE_TUCKER
    tinit = hosvd_init(x, (trank,) * x.ndim)
    order = list(SPANS_PER_ITER) + ["tucker"]

    def run(name, ctx):
        if name == "tucker":
            return repro_torch.tucker_hooi(x, (trank,) * x.ndim, sweeps, init_factors=tinit,
                                           ctx=ctx)
        return repro_torch.cp_als(x, rank, iters, init_factors=init, sweep=name, ctx=ctx)

    untraced = {name: run(name, plain) for name in order}
    torch.cuda.synchronize()
    path = os.path.join(tmp, "main_path.jsonl")
    before = registry().snapshot()
    traced, launched, problems = {}, {}, []
    with Trace(path=path) as tr:
        for name in order:
            with collect.collecting() as launched[name]:
                traced[name] = run(name, obs)
    torch.cuda.synchronize()
    dispatched = registry().delta(before).get(CUDA_DISPATCHES, 0)
    events = load_trace(path)
    if events != tr.events:
        problems.append("the JSONL file does not read back as the trace's events")
    # split the events by run: each run ends with its last iteration's event
    runs: dict = {}
    cur: list = []
    for e in events:
        cur.append(e)
        if e["kind"] in ("cp_als_iter", "tucker_iter") and e["it"] == (
                iters if e["kind"] == "cp_als_iter" else sweeps) - 1:
            runs[order[len(runs)]] = cur
            cur = []
    mem = Memory.h100_smem(itemsize=4)
    per_run = {}
    for name in order:
        evs = runs.get(name, [])
        kinds = {k: sum(e["kind"] == k for e in evs) for k in DISPATCH_KINDS}
        want = {k: 0 for k in DISPATCH_KINDS}
        if name == "tucker":
            want["multi_ttm"] = x.ndim * sweeps
            it_kind, n_it = "tucker_iter", sweeps
        else:
            want.update({k: n * iters for k, n in SPANS_PER_ITER[name].items()})
            it_kind, n_it = "cp_als_iter", iters
        its = [e for e in evs if e["kind"] == it_kind]
        if kinds != want:
            problems.append(f"{name}: dispatch events {kinds}, expected {want}")
        if [e["fit"] for e in its] != traced[name].fits or len(its) != n_it:
            problems.append(f"{name}: {len(its)} {it_kind} events, fits "
                            f"{[e['fit'] for e in its]} against {traced[name].fits}")
        problems += [f"{name}: {p}" for p in _dispatch_checks(evs, launched[name], mem)]
        a, b = traced[name], untraced[name]
        same = a.fits == b.fits and all(torch.equal(f, g) for f, g in zip(a.factors, b.factors))
        if not same:
            problems.append(f"{name}: traced fits {a.fits} differ from untraced {b.fits}")
        per_run[name] = {"dispatch_events": kinds, "fits": a.fits,
                         "bit_identical_to_untraced": same, "spans": _span_summary(evs)}
    n_dispatch = sum(e["kind"] in DISPATCH_KINDS for e in events)
    if dispatched != n_dispatch:
        problems.append(f"engine.cuda_dispatches rose by {dispatched}, {n_dispatch} events")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.observe.report", path],
                          capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        problems.append(f"the report exited {proc.returncode}: {proc.stderr}")
    rec = {"observe": "main_path", "shape": list(x.shape), "rank": rank, "iters": iters,
           "tucker_rank": trank, "sweeps": sweeps, "events": len(events),
           "cuda_dispatches": dispatched, "runs": per_run, "report_rc": proc.returncode,
           "gpu": smi}
    emit(rec)
    if problems:
        raise AssertionError("observe 13a: " + "; ".join(problems))
    return rec


def observe_span_cost(gen, x, init, plain, obs, smi: str) -> dict:
    """13b: the host µs of one engine call with no trace against a trace
    that refuses it, then against a traced call, each pair interleaved call
    by call (both see the host's noise alike; medians of the per-call
    times), and
    ``per_mode``'s ms an iteration with and without a trace."""
    import torch
    import repro_torch
    from repro_torch.observe import Trace

    pdims, prank, calls = SPAN_PROBE
    px = torch.randn(pdims, generator=gen, device="cuda")
    pf = [torch.randn((d, prank), generator=gen, device="cuda") for d in pdims]
    gated = Trace(capture="observed")
    traced = Trace(capture="observed", capacity=2 * calls)

    def one(ctx, trace) -> float:
        if trace is not None:
            trace.__enter__()
        t0 = time.perf_counter()
        repro_torch.mttkrp(px, pf, 0, ctx=ctx)
        dt = time.perf_counter() - t0
        if trace is not None:
            trace.__exit__(None, None, None)
        return dt * 1e6

    def paired(a, b) -> tuple:
        """Per-call µs of two states alternated A B B A, after 20 warm calls
        each: each state follows the other as often as itself."""
        out: tuple = ([], [])
        for i in range(calls + 20):
            for k in ((0, 1) if i % 2 == 0 else (1, 0)):
                t = one(*(a, b)[k])
                if i >= 20:
                    out[k].append(t)
            if i % 20 == 19:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return out

    # the zero-overhead contract: no trace against a trace that refuses the
    # call; then the cost of a span: no trace against traced
    none_a, gate = paired((plain, None), (plain, gated))
    none_b, span = paired((plain, None), (obs, traced))
    samples = {"no_trace": none_a, "gate_refuses": gate, "no_trace_2": none_b, "traced": span}
    quart = {name: [sorted(v)[len(v) * q // 4] for q in (1, 2, 3)]
             for name, v in samples.items()}
    med = {name: q[1] for name, q in quart.items()}
    gate_ratio = med["gate_refuses"] / med["no_trace"]
    if len(gated) != 0 or len(traced) != calls + 20:
        raise AssertionError(f"observe 13b: the refused gate recorded {len(gated)} events, "
                             f"the trace {len(traced)}")
    _, rank, iters = OBSERVE_CP
    iter_ms: dict = {"untraced": [], "traced": []}
    for label in ("untraced", "traced", "traced", "untraced"):
        trace = Trace() if label == "traced" else None
        if trace is not None:
            trace.__enter__()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            repro_torch.cp_als(x, rank, iters, init_factors=init,
                               ctx=obs if trace is not None else plain)
            torch.cuda.synchronize()
            iter_ms[label].append((time.perf_counter() - t0) / iters * 1e3)
        finally:
            if trace is not None:
                trace.__exit__(None, None, None)
    rec = {"observe": "span_cost", "shape": list(pdims), "rank": prank, "calls_each": calls,
           "host_us_median": med, "host_us_quartiles": quart,
           "gate_over_no_trace": gate_ratio,
           "span_us_per_dispatch": med["traced"] - med["no_trace_2"],
           "per_mode_ms_per_iter": {k: sum(v) / len(v) for k, v in iter_ms.items()},
           "per_mode_ms_runs": iter_ms, "gpu": smi}
    emit(rec)
    if abs(gate_ratio - 1.0) > GATE_TOL:
        raise AssertionError(f"observe 13b: a trace that refuses the call costs "
                             f"{gate_ratio:.3f}x no trace (limit 1 +- {GATE_TOL})")
    return rec


def observe_profiler(gen, x, init, obs, smi: str) -> dict:
    """13c: one traced ``per_mode`` iteration under ``torch.profiler``: every
    Hopper kernel under its dispatch's ``record_function`` range, one MTTKRP
    kernel a range, the device ms under each; then a CUDA graph captured
    under an active trace: no event, the eager result on replay."""
    import torch
    import repro_torch
    from repro_torch.observe import Trace
    from torch.profiler import ProfilerActivity, profile

    rank = OBSERVE_CP[1]
    with Trace():
        repro_torch.cp_als(x, rank, 1, init_factors=init, ctx=obs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            repro_torch.cp_als(x, rank, 1, init_factors=init, ctx=obs)
            torch.cuda.synchronize()
    # kineto puts each record_function range on the device timeline too, over
    # the kernels launched inside it: each kernel is attributed to the range
    # whose device interval holds it
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in device if e.is_user_annotation and e.name.startswith("repro_torch.")]
    ranges: dict = {}
    ours, outside = 0, []
    for k in device:
        if k.is_user_annotation:
            continue
        mine = HOPPER_KERNEL.search(k.name)
        ours += bool(mine)
        span = next((a for a in spans if a.time_range.start <= k.time_range.start
                     and k.time_range.end <= a.time_range.end), None)
        if span is None:
            if mine:
                outside.append(k.name)
            continue
        d = ranges.setdefault(span.name, {"device_ms": 0.0, "kernels": {}})
        d["device_ms"] += k.time_range.elapsed_us() / 1e3
        short = mine.group(0) if mine else k.name[:60]
        d["kernels"][short] = d["kernels"].get(short, 0) + 1
    problems = []
    want_ranges = {f"repro_torch.mttkrp.mode{m}" for m in range(x.ndim)}
    if ours == 0 or outside or set(ranges) != want_ranges:
        problems.append(f"{ours} Hopper kernels in the profile, {len(outside)} outside a "
                        f"dispatch range ({outside[:3]}); ranges {sorted(ranges)}")
    for name, d in ranges.items():
        if d["kernels"].get("mttkrp_mma_kernel") != 1:
            problems.append(f"{name}: kernels {d['kernels']}, expected one mttkrp kernel")
    gx = torch.randn((256, 256, 256), generator=gen, device="cuda")
    gf = [torch.randn((256, 32), generator=gen, device="cuda") for _ in range(3)]
    with Trace() as gt:
        want = repro_torch.mttkrp(gx, gf, 1, ctx=obs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            repro_torch.mttkrp(gx, gf, 1, ctx=obs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            got = repro_torch.mttkrp(gx, gf, 1, ctx=obs)
        captured = len(gt) - 2  # the two eager calls recorded, the capture nothing
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
    replay_equal = bool(torch.equal(got, want))
    if captured != 0 or not replay_equal:
        problems.append(f"graph capture under a trace: {captured} events recorded, replay "
                        f"equal to the eager call: {replay_equal}")
    rec = {"observe": "profiler", "hopper_kernels": ours, "ranges": ranges,
           "graph_capture_events": captured, "graph_replay_equal": replay_equal, "gpu": smi}
    emit(rec)
    if problems:
        raise AssertionError("observe 13c: " + "; ".join(problems))
    return rec


def observe_audits(gen, plain, tmp: str, smi: str) -> dict:
    """13d: each audit's triple and ratios; measured at least the operands
    and the output once."""
    import torch
    from repro_torch.core.tensor import random_factors
    from repro_torch.observe import Trace, audit_mttkrp, audit_multi_ttm

    rows, x = [], None
    with Trace(path=os.path.join(tmp, "audit.jsonl")):
        for kind, dims, rank, which in AUDITS:
            if x is None or tuple(x.shape) != tuple(dims):
                x = None  # free the last shape's tensor before making the next
                x = noisy_low_rank(gen, dims, rank)
            if kind == "mttkrp":
                fs = random_factors(gen, dims, rank)
                row = audit_mttkrp(x, fs, which, ctx=plain)
                once = x.nbytes + sum(f.nbytes for k, f in enumerate(fs) if k != which) \
                    + dims[which] * rank * 4
            else:
                mats = [torch.linalg.qr(torch.randn((d, rank), generator=gen,
                                                    device="cuda"))[0] for d in dims]
                row = audit_multi_ttm(x, mats, which, ctx=plain)
                out_words = rank ** len(dims) if which is None else \
                    dims[which] * rank ** (len(dims) - 1)
                once = x.nbytes + sum(m.nbytes for k, m in enumerate(mats) if k != which) \
                    + out_words * 4
            d = {"observe": "audit", **row.to_dict(), "operands_and_output_once": once,
                 "gpu": smi}
            emit(d)
            rows.append(d)
            if row.measured_bytes < once:
                raise AssertionError(f"observe 13d: {row.name} measured {row.measured_bytes} "
                                     f"bytes, below the operands and the output once ({once})")
    return {"observe": "audits", "rows": rows}


def observe_serve_and_tune(gen, smi: str) -> dict:
    """13e: phase 11's mixed flush under a trace, and ``tune_mttkrp`` on an
    isolated cache: the spans and the registry's tune counters."""
    import torch
    import repro_torch
    from repro_torch.core.tensor import random_factors
    from repro_torch.launch.serve import DecompositionServer
    from repro_torch.observe import Trace, registry
    from repro_torch.observe.metrics import TUNE_CACHE_HITS, TUNE_CANDIDATES, TUNE_SEARCH_TIME_US
    from repro_torch.tune import search
    from repro_torch.tune.cache import isolated_cache

    with isolated_cache():
        server = DecompositionServer(repro_torch.ExecutionContext.create("auto", observe=True),
                                     n_iters=SERVE_ITERS)
        n_req = 0
        for count, (lo, hi), rank, ways in SERVE_QUEUE:
            for _ in range(count):
                shape = tuple(torch.randint(lo, hi + 1, (ways,), generator=gen,
                                            device="cuda").tolist())
                server.submit(noisy_low_rank(gen, shape, rank), rank, request_id=f"obs{n_req}")
                n_req += 1
        with Trace(capture="observed") as st:
            results = server.flush()
        kinds = [e["kind"] for e in st.events]
        iters_run: dict = {}
        for r in results.values():
            iters_run[r.bucket] = max(iters_run.get(r.bucket, 0), r.n_iters)
        serve_ok = (kinds.count("serve_bucket") == len(SERVE_QUEUE)
                    and kinds.count("serve_request") == n_req
                    and kinds.count("cp_als_batched_iter") == sum(iters_run.values()))
        dims, rank = OBSERVE_TUNE
        tx = noisy_low_rank(gen, dims, rank)
        tfs = random_factors(gen, dims, rank)
        hist = len(registry().histogram(TUNE_SEARCH_TIME_US))
        before = registry().snapshot()
        with Trace() as tt:
            res = search.tune_mttkrp(tx, tfs, 0, ctx=repro_torch.ExecutionContext.create("auto"))
        measured = registry().delta(before).get(TUNE_CANDIDATES, 0)
        searches = [e for e in tt.events if e["kind"] == "tune_search"]
        observed = len(registry().histogram(TUNE_SEARCH_TIME_US)) - hist
        before = registry().snapshot()
        replay = search.resolve(dims, rank, 0, torch.float32, device=tx.device)
        hits = registry().delta(before).get(TUNE_CACHE_HITS, 0)
        tune_ok = (len(searches) == 1 and measured == searches[0]["timed"] and observed == 1
                   and hits == 1 and replay.cache_hit)
    rec = {"observe": "serve_and_tune", "requests": n_req,
           "events": {k: kinds.count(k) for k in sorted(set(kinds))},
           "iterations_by_bucket": list(iters_run.values()),
           "tune_search_events": len(searches), "candidates": len(res.measurements),
           "candidates_measured": measured,
           "search_time_us": searches[0]["search_time_us"] if searches else None,
           "search_time_observations": observed, "replay_cache_hits": hits, "gpu": smi}
    emit(rec)
    if not (serve_ok and tune_ok):
        raise AssertionError(f"observe 13e: {rec}")
    return rec

def dist_cp_problem(seed: int):
    """Phase 14's CP problem, the same in every process from ``seed``: a
    1000^3 tensor of CP rank 64 plus noise, and the initial factors."""
    import torch
    from repro_torch.core.tensor import random_factors

    dims, rank, _ = DIST_CP
    gen = torch.Generator(device="cuda").manual_seed(seed + DIST_SEED)
    x = noisy_low_rank(gen, dims, rank)
    return x, random_factors(gen, dims, rank)


def dist_tucker_problem(seed: int):
    """Phase 14d's Tucker problem, the same in every process from ``seed``:
    a 1000^3 tensor of multilinear rank 32 plus 10 % noise."""
    import torch

    dims, ranks, _ = DIST_TUCKER
    gen = torch.Generator(device="cuda").manual_seed(seed + DIST_SEED + 3)
    return noisy_tucker(gen, dims, ranks)


def _digest(t) -> str:
    """The bytes of a tensor, hashed: equal digests are equal bits."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _alg_problem(seed: int, dims, rank: int, salt: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + DIST_SEED + salt)
    x = torch.randn(dims, generator=gen, device="cuda")
    return x, [torch.randn((d, rank), generator=gen, device="cuda") for d in dims]


def dist_rank(rank: int, tmp: str, seed: int) -> int:
    """One rank of phase 14, in a process of its own: joins the gloo group
    on ``tmp``'s file store, runs 14a-14e on its blocks (counts set to 0
    before each run and read after) and writes ``rank{rank}.json`` (and
    rank 0 the gathered factors and the Tucker results) into ``tmp``."""
    import torch
    import torch.distributed as dist
    import repro_torch
    from repro_torch.core.bounds import par_general_cost, par_stationary_cost
    from repro_torch.core.tensor import random_low_rank_tensor, relative_error
    from repro_torch.core.tucker import hosvd_init
    from repro_torch.distributed import collectives
    from repro_torch.distributed.compression import (
        compressed_gradient, compression_ratio, cp_compressed_mean, init_compression_state,
        pick_3way_shape)
    from repro_torch.distributed.grid_select import multi_ttm_sweep_words, stationary_sweep_words
    from repro_torch.distributed.mesh import world_group
    from repro_torch.distributed.mesh import make_grid_mesh
    from repro_torch.distributed.mttkrp_parallel import (
        mttkrp_general, mttkrp_stationary, output_block, place_inputs)
    from repro_torch.kernels import build
    from repro_torch.kernels.mttkrp3 import mttkrp3_plain
    from repro_torch.kernels.mttkrpn import mttkrpn_plain
    from repro_torch.observe.metrics import SWEEP_COLLECTIVE_BYTES, registry

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"),
                                                         DIST_RANKS),
                            rank=rank, world_size=DIST_RANKS)
    kernels = counters()
    out: dict = {"rank": rank, "device": torch.cuda.get_device_name(0), "cp": {}}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def launches():
        return {name: k.launches for name, k in kernels.items()}

    try:
        x, init = dist_cp_problem(seed)
        dims, r, iters = DIST_CP
        for overlap in ("none", "ring"):
            ctx = repro_torch.ExecutionContext.create("cuda", distributed=True, overlap=overlap,
                                                      observe=True)
            # one untimed iteration first: the first call of a process pays
            # one-time set-up (the groups' connections, the solver library)
            repro_torch.cp_als(x, r, 1, init_factors=init, ctx=ctx)
            hist0 = len(registry().histogram(SWEEP_COLLECTIVE_BYTES))
            before = collectives.COUNTER.snapshot()
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with repro_torch.Trace() as tr:
                res = repro_torch.cp_als(x, r, iters, init_factors=init, ctx=ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by_kind = collectives.COUNTER.delta(before)
            (event,) = [e for e in tr.events if e["kind"] == "cp_sweep_collectives"]
            iter_ms = wall / iters * 1e3
            coll_ms = collectives.seconds_total(by_kind) / iters * 1e3
            out["cp"][overlap] = {
                "grid": event["grid"], "fits": res.fits, "launches": launches(),
                "sweep_bytes": list(registry().histogram(SWEEP_COLLECTIVE_BYTES)[hist0:]),
                "model_bytes": stationary_sweep_words(dims, r, event["grid"]) * 4,
                "fit_allreduce_bytes": event["fit_allreduce_bytes"],
                "collectives_by_kind": event["collectives_by_kind"],
                "transport": event["transport"],
                "factor_digest": [float(f.double().abs().sum()) for f in res.factors],
                "iter_ms": iter_ms, "collective_ms": coll_ms, "local_ms": iter_ms - coll_ms,
            }
            if rank == 0:
                torch.save({"factors": [f.cpu() for f in res.factors],
                            "weights": res.weights.cpu()},
                           os.path.join(tmp, f"factors_{overlap}.pt"))
            del res
        del x, init
        torch.cuda.empty_cache()
        # 14d: HOOI from HOSVD on the grid choose_tucker_grid picks
        x = dist_tucker_problem(seed)
        dims, ranks, sweeps = DIST_TUCKER
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        init = hosvd_init(x, ranks)
        torch.cuda.synchronize()
        out["tucker_hosvd_ms"] = (time.perf_counter() - t0) * 1e3
        out["tucker"] = {}
        for overlap in ("none", "ring"):
            ctx = repro_torch.ExecutionContext.create("cuda", distributed=True, overlap=overlap,
                                                      observe=True)
            repro_torch.tucker_hooi(x, ranks, 1, init_factors=init, ctx=ctx)  # untimed
            hist0 = len(registry().histogram(SWEEP_COLLECTIVE_BYTES))
            before = collectives.COUNTER.snapshot()
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with repro_torch.Trace() as tr:
                res = repro_torch.tucker_hooi(x, ranks, sweeps, init_factors=init, ctx=ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by_kind = collectives.COUNTER.delta(before)
            (event,) = [e for e in tr.events if e["kind"] == "tucker_sweep_collectives"]
            sweep_ms = wall / sweeps * 1e3
            coll_ms = collectives.seconds_total(by_kind) / sweeps * 1e3
            out["tucker"][overlap] = {
                "grid": event["grid"], "fits": res.fits, "launches": launches(),
                "sweep_bytes": list(registry().histogram(SWEEP_COLLECTIVE_BYTES)[hist0:]),
                "model_bytes": multi_ttm_sweep_words(dims, ranks, event["grid"]) * 4,
                "event_bytes": [event["measured_collective_bytes"], event["modeled_bytes"]],
                "collectives_by_kind": event["collectives_by_kind"],
                "transport": event["transport"],
                "factor_digest": [_digest(f) for f in res.factors] + [_digest(res.core)],
                "sweep_ms": sweep_ms, "collective_ms": coll_ms, "local_ms": sweep_ms - coll_ms,
            }
            if rank == 0:
                torch.save({"factors": [f.cpu() for f in res.factors], "core": res.core.cpu()},
                           os.path.join(tmp, f"tucker_{overlap}.pt"))
            del res
        del x, init
        torch.cuda.empty_cache()
        ctx = repro_torch.ExecutionContext.create("cuda")
        for name, (dims, r, p0, grid, mode), salt in (
                ("alg3", (DIST_ALG3[0], DIST_ALG3[1], 1, DIST_ALG3[2], DIST_ALG3[3]), 1),
                ("alg4", DIST_ALG4, 2)):
            xf, fs = _alg_problem(seed, dims, r, salt)
            rest = [f for k, f in enumerate(fs) if k != mode]
            want = (mttkrp3_plain(xf, *rest) if len(dims) == 3 else mttkrpn_plain(xf, rest))
            mesh = make_grid_mesh(grid, p0=p0, dims=dims, rank=r)
            want = output_block(want, mesh, mode, rank_axis=p0 > 1)
            xs, fl = place_inputs(mesh, xf, fs, mode, rank_axis=p0 > 1)
            del xf, fs, rest
            torch.cuda.empty_cache()
            fn = (mttkrp_general if p0 > 1 else mttkrp_stationary)(mesh, mode, len(dims),
                                                                     ctx=ctx)
            zero()
            before = collectives.COUNTER.snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(xs, *fl)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            by_kind = collectives.COUNTER.delta(before)
            model = (par_general_cost(dims, r, grid, p0, mode) if p0 > 1
                     else par_stationary_cost(dims, r, grid, mode)) * 4
            rel, diff = rel_err(got, want)
            out[name] = {"shape": list(dims), "rank": r, "p0": p0, "grid": list(grid),
                         "mode": mode, "launches": launches(), "max_rel_err": rel,
                         "max_abs_err": diff, "bytes": collectives.ring_total(by_kind),
                         "model_bytes": model, "collectives_by_kind": by_kind,
                         "call_ms": ms, "finite": bool(torch.isfinite(got).all())}
            del xs, fl, got, want
            torch.cuda.empty_cache()
        # 14e: CP gradient compression of an MLP gradient, one a rank (the
        # reference check's construction: a rank-3 base plus rank x 0.01 of
        # a rank-2 delta), against the true mean
        shape, r, sweeps = DIST_COMPRESS
        dims = pick_3way_shape(shape)
        gen = torch.Generator(device="cuda").manual_seed(seed + DIST_SEED + 4)
        base, _ = random_low_rank_tensor(gen, dims, 3)
        delta, _ = random_low_rank_tensor(gen, dims, 2)
        g = base + rank * 0.01 * delta
        g_mean = base + 0.01 * (sum(range(DIST_RANKS)) / DIST_RANKS) * delta
        group = world_group()
        zero()
        before = collectives.COUNTER.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon, _ = cp_compressed_mean(
            g, group, r, sweeps,
            generator=torch.Generator(device="cuda").manual_seed(seed + DIST_SEED + 5))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        by_kind = collectives.COUNTER.delta(before)
        step_r, step_sweeps = COMPRESS_STEP
        state = init_compression_state(
            torch.Generator(device="cuda").manual_seed(seed + DIST_SEED + 6), shape, step_r)
        step_before = collectives.COUNTER.snapshot()
        approx, state = compressed_gradient(g.reshape(shape), state, group, sweeps=step_sweeps)
        step_kind = collectives.COUNTER.delta(step_before)
        out["compress"] = {
            "shape": list(shape), "dims": list(dims), "rank": r, "sweeps": sweeps,
            "rel_err": float(relative_error(g_mean, recon)), "digest": _digest(recon),
            "finite": bool(torch.isfinite(recon).all()), "launches": launches(),
            "collectives_by_kind": by_kind,
            "operand_bytes": by_kind["all-reduce"]["operand_bytes"],
            "model_operand_bytes": sweeps * sum(dims) * r * 4,
            "gradient_bytes": g.numel() * g.element_size(), "call_ms": ms,
            "collective_ms": collectives.seconds_total(by_kind) * 1e3,
            "step": {"rank": step_r, "sweeps": step_sweeps,
                     "operand_bytes": step_kind["all-reduce"]["operand_bytes"],
                     "model_operand_bytes": step_sweeps * sum(dims) * step_r * 4,
                     "ratio": compression_ratio(shape, step_r, step_sweeps),
                     "finite": bool(torch.isfinite(approx).all()),
                     "approx_digest": _digest(approx)},
        }
        del base, delta, g, g_mean, recon, approx, state
        torch.cuda.empty_cache()
        out["loaded"] = {k: str(v) for k, v in build.loaded().items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _ring_launches(grid, ndim: int) -> int:
    """``mttkrp3`` launches of one ``overlap="ring"`` sweep: mode 0 one;
    every later mode one a ring arrival of the mode before, whose
    hyperslice holds P/P_{m-1} ranks."""
    procs = math.prod(grid)
    return 1 + sum(procs // grid[m - 1] for m in range(1, ndim))


def dist_phase(seed: int, smi: str, built: dict) -> dict:
    """Phase 14: the distributed path, DIST_RANKS ranks on the one card.
    The ranks start first; meanwhile this process runs the sequential
    ``cuda`` CP-ALS from the same factors, the yardstick of 14a and 14b.
    Then every rank's readings are checked: fits and gathered factors
    against the sequential run, the sweep's counted bytes against
    ``stationary_sweep_words`` x 4 plus the fit's all-reduce exactly, the
    launches exactly, Alg 3 and Alg 4 against the plain MTTKRP and their
    bytes against Eq (12) and Eq (16) exactly; each rank loaded the
    libraries phase 2 built (it has no ``nvcc`` to build with)."""
    import tempfile

    import torch
    import repro_torch
    from repro_torch.core.tucker import hosvd_init
    from repro_torch.distributed.grid_select import choose_tucker_grid

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    nvcc_dirs = {os.path.dirname(p) for p in (shutil.which("nvcc"),) if p}
    env = {**os.environ, "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
           "CUDA_HOME": os.path.join(tmp, "no-nvcc"),
           "PATH": os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                                   if d not in nvcc_dirs)}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--dist-rank", str(r), tmp], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(DIST_RANKS)]
    try:
        x, init = dist_cp_problem(seed)
        dims, rank, iters = DIST_CP
        ctx = repro_torch.ExecutionContext.create("cuda")
        seq = repro_torch.cp_als(x, rank, iters, init_factors=init, sweep="per_mode", ctx=ctx)
        seq_fits, seq_weights = seq.fits, seq.weights.cpu()
        seq_factors = [f.cpu() for f in seq.factors]
        del x, init, seq
        torch.cuda.empty_cache()
        # 14d's yardstick: the sequential cuda HOOI from the same HOSVD
        x = dist_tucker_problem(seed)
        tdims, tranks, tsweeps = DIST_TUCKER
        tseq = repro_torch.tucker_hooi(x, tranks, tsweeps, init_factors=hosvd_init(x, tranks),
                                       ctx=ctx)
        tseq_fits, tseq_core = tseq.fits, tseq.core.cpu()
        tseq_factors = [f.cpu() for f in tseq.factors]
        del x, tseq
        torch.cuda.empty_cache()
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=420)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 14: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(DIST_RANKS)]
    want_loaded = {src: str(path) for src, (path, _) in built.items()}
    out = {"launches": {name: 0 for name in KERNELS}, "ranks": DIST_RANKS}
    for r, rec in enumerate(ranks):
        if any(want_loaded[src] != path for src, path in rec["loaded"].items()):
            raise AssertionError(f"phase 14: rank {r} loaded {rec['loaded']}, not phase 2's "
                                 f"{want_loaded}")
    for overlap in ("none", "ring"):
        saved = torch.load(os.path.join(tmp, f"factors_{overlap}.pt"))
        gaps = [max(abs(a - b) for a, b in zip(rec["cp"][overlap]["fits"], seq_fits))
                for rec in ranks]
        ferr = max(rel_err(f, g)[0] for f, g in zip(saved["factors"], seq_factors))
        werr = rel_err(saved["weights"], seq_weights)[0]
        per_iter = 3 if overlap == "none" else _ring_launches(ranks[0]["cp"][overlap]["grid"], 3)
        for r, rec in enumerate(ranks):
            c = rec["cp"][overlap]
            want_bytes = c["model_bytes"] + c["fit_allreduce_bytes"]
            if c["sweep_bytes"] != [want_bytes] * iters:
                raise AssertionError(f"14 {overlap}: rank {r} sweep bytes {c['sweep_bytes']}, "
                                     f"model {want_bytes}")
            if c["launches"]["mttkrp3"] != per_iter * iters or any(
                    c["launches"][k] for k in COUNTED if k != "mttkrp3"):
                raise AssertionError(f"14 {overlap}: rank {r} launches {c['launches']}, "
                                     f"expected {per_iter} mttkrp3 an iteration")
            if c["factor_digest"] != ranks[0]["cp"][overlap]["factor_digest"]:
                raise AssertionError(f"14 {overlap}: rank {r}'s gathered factors differ")
            for name, n in c["launches"].items():
                out["launches"][name] += n
        if max(gaps) > DIST_TOL or ferr > DIST_TOL or werr > DIST_TOL:
            raise AssertionError(f"14 {overlap}: fit gap {max(gaps):.2e}, factors {ferr:.2e}, "
                                 f"weights {werr:.2e} against the sequential run")
        row = {"distributed_cp": list(dims), "rank": rank, "iters": iters, "overlap": overlap,
               "ranks": DIST_RANKS, "grid": ranks[0]["cp"][overlap]["grid"],
               "transport": ranks[0]["cp"][overlap]["transport"],
               "fits": ranks[0]["cp"][overlap]["fits"], "sequential_fits": seq_fits,
               "max_fit_gap": max(gaps), "factor_rel_err": ferr, "weights_rel_err": werr,
               "sweep_bytes": ranks[0]["cp"][overlap]["sweep_bytes"][0],
               "collectives_by_kind": ranks[0]["cp"][overlap]["collectives_by_kind"],
               "mttkrp3_per_rank_iter": per_iter,
               "iter_ms": [rec["cp"][overlap]["iter_ms"] for rec in ranks],
               "local_ms": [rec["cp"][overlap]["local_ms"] for rec in ranks],
               "collective_ms": [rec["cp"][overlap]["collective_ms"] for rec in ranks],
               "timing": f"{DIST_RANKS} ranks share one card: no speed figure", "gpu": smi}
        emit(row)
        out["cp_" + overlap] = row
    # 14d: the Tucker sweep against the sequential run
    want_grid = list(choose_tucker_grid(tdims, tranks, DIST_RANKS).grid)
    for overlap in ("none", "ring"):
        saved = torch.load(os.path.join(tmp, f"tucker_{overlap}.pt"))
        gaps = [max(abs(a - b) for a, b in zip(rec["tucker"][overlap]["fits"], tseq_fits))
                for rec in ranks]
        ferr = max(rel_err(f, g)[0] for f, g in zip(saved["factors"], tseq_factors))
        cerr = rel_err(saved["core"], tseq_core)[0]
        for r, rec in enumerate(ranks):
            t = rec["tucker"][overlap]
            if t["grid"] != want_grid:
                raise AssertionError(f"14d {overlap}: rank {r} grid {t['grid']}, "
                                     f"choose_tucker_grid {want_grid}")
            if t["sweep_bytes"] != [t["model_bytes"]] * tsweeps \
                    or t["event_bytes"] != [t["model_bytes"]] * 2:
                raise AssertionError(f"14d {overlap}: rank {r} sweep bytes {t['sweep_bytes']}, "
                                     f"event {t['event_bytes']}, model {t['model_bytes']}")
            if t["launches"]["multi_ttm_keep"] != len(tdims) * tsweeps or any(
                    n for k, n in t["launches"].items() if k != "multi_ttm_keep"):
                raise AssertionError(f"14d {overlap}: rank {r} launches {t['launches']}, "
                                     f"expected {len(tdims)} multi_ttm_keep a sweep")
            if t["factor_digest"] != ranks[0]["tucker"][overlap]["factor_digest"]:
                raise AssertionError(f"14d {overlap}: rank {r}'s factors or core differ from "
                                     f"rank 0's")
            for name, n in t["launches"].items():
                out["launches"][name] += n
        if max(gaps) > DIST_TOL or ferr > DIST_CORE_TOL or cerr > DIST_CORE_TOL:
            raise AssertionError(f"14d {overlap}: fit gap {max(gaps):.2e}, factors {ferr:.2e}, "
                                 f"core {cerr:.2e} against the sequential run")
        first = ranks[0]["tucker"][overlap]
        row = {"distributed_tucker": list(tdims), "ranks": list(tranks), "sweeps": tsweeps,
               "overlap": overlap, "procs": DIST_RANKS, "grid": first["grid"],
               "transport": first["transport"], "fits": first["fits"],
               "sequential_fits": tseq_fits, "max_fit_gap": max(gaps),
               "factor_rel_err": ferr, "core_rel_err": cerr, "sweep_bytes": first["sweep_bytes"][0],
               "collectives_by_kind": first["collectives_by_kind"],
               "multi_ttm_keep_per_rank_sweep": len(tdims), "factor_digests_equal": True,
               "hosvd_ms": [rec["tucker_hosvd_ms"] for rec in ranks],
               "sweep_ms": [rec["tucker"][overlap]["sweep_ms"] for rec in ranks],
               "local_ms": [rec["tucker"][overlap]["local_ms"] for rec in ranks],
               "collective_ms": [rec["tucker"][overlap]["collective_ms"] for rec in ranks],
               "timing": f"{DIST_RANKS} ranks share one card: no speed figure", "gpu": smi}
        emit(row)
        out["tucker_" + overlap] = row
    # 14e: the compressed mean, the same on every rank, near the true mean
    comp = [rec["compress"] for rec in ranks]
    for r, c in enumerate(comp):
        st = c["step"]
        if (not c["finite"] or c["rel_err"] > COMPRESS_TOL or c["digest"] != comp[0]["digest"]
                or c["operand_bytes"] != c["model_operand_bytes"]
                or set(c["collectives_by_kind"]) != {"all-reduce"}
                or c["operand_bytes"] >= c["gradient_bytes"] or any(c["launches"].values())
                or st["operand_bytes"] != st["model_operand_bytes"] or not st["finite"]
                or st["approx_digest"] != comp[0]["step"]["approx_digest"]
                or round(st["ratio"], 1) != round(comp[0]["step"]["ratio"], 1)):
            raise AssertionError(f"14e: rank {r}: {json.dumps(c)}")
    emit({"distributed_compression": comp[0]["shape"], "dims": comp[0]["dims"],
          "rank": comp[0]["rank"], "sweeps": comp[0]["sweeps"], "procs": DIST_RANKS,
          "rel_err": [c["rel_err"] for c in comp], "reconstructions_equal": True,
          "operand_bytes": comp[0]["operand_bytes"], "gradient_bytes": comp[0]["gradient_bytes"],
          "step_operand_bytes": comp[0]["step"]["operand_bytes"],
          "step_rank": comp[0]["step"]["rank"], "step_ratio": comp[0]["step"]["ratio"],
          "call_ms": [c["call_ms"] for c in comp],
          "collective_ms": [c["collective_ms"] for c in comp],
          "timing": f"{DIST_RANKS} ranks share one card: no speed figure", "gpu": smi})
    out["compress"] = comp[0]
    for name, kernel in (("alg3", "mttkrpn"), ("alg4", "mttkrp3")):
        for r, rec in enumerate(ranks):
            a = rec[name]
            if not a["finite"] or a["max_rel_err"] > ALG_TOL or a["bytes"] != a["model_bytes"] \
                    or a["launches"][kernel] != 1:
                raise AssertionError(f"14c {name}: rank {r}: {a}")
            for k, n in a["launches"].items():
                out["launches"][k] += n
        emit({"distributed_" + name: ranks[0][name]["shape"], "rank": ranks[0][name]["rank"],
              "p0": ranks[0][name]["p0"], "grid": ranks[0][name]["grid"],
              "mode": ranks[0][name]["mode"], "kernel": kernel,
              "max_rel_err": max(rec[name]["max_rel_err"] for rec in ranks),
              "bytes": ranks[0][name]["bytes"], "model_bytes": ranks[0][name]["model_bytes"],
              "call_ms": [rec[name]["call_ms"] for rec in ranks],
              "timing": f"{DIST_RANKS} ranks share one card: no speed figure", "gpu": smi})
    return out



def verify_phase(smi: str) -> dict:
    """Phase 15a: the plan verifier. ``verify_plans()`` (the reference's
    checks over its lattice and ``Memory.h100_smem``) and
    ``check_kernel_plans()`` (the Hopper kernels' choosers over the port's
    cells) give no finding, and for every case of the kernel-plan lattice
    the Python mirror of the chosen plan's shared memory equals the count of
    the library phase 2 built (``repro_*_smem_bytes``)."""
    import torch
    from repro_torch.kernels import multi_ttm as multi_ttm_mod
    from repro_torch.kernels import partial as partial_mod
    from repro_torch.kernels import splitk
    from repro_torch.kernels import sweep as sweep_mod
    from repro_torch.verify.plans import (
        check_kernel_plans, choose_kernel_plan, default_kernel_cases, kernel_smem_bytes,
        verify_plans)

    t0 = time.perf_counter()
    plan_findings, kernel_findings = verify_plans(), check_kernel_plans()
    host_s = time.perf_counter() - t0
    library = {"mttkrp": lambda c, p, dt: splitk.smem_bytes(p, dt, len(c.shape) - 1),
               "pair": lambda c, p, dt: sweep_mod.smem_bytes(p, dt, len(c.shape) - 1),
               "multi_ttm": lambda c, p, dt: multi_ttm_mod.smem_bytes(p, dt, c.rank),
               "partial": lambda c, p, dt: partial_mod.smem_bytes(p, dt, c.rank)}
    cases = default_kernel_cases()
    unequal = []
    by_kernel: dict = {}
    for case in cases:
        plan = choose_kernel_plan(case)
        dtype = torch.float32 if case.itemsize == 4 else torch.bfloat16
        mirror, lib = kernel_smem_bytes(case, plan), library[case.kernel](case, plan, dtype)
        by_kernel[case.kernel] = by_kernel.get(case.kernel, 0) + 1
        if mirror != lib:
            unequal.append({"case": str(case), "plan": repr(plan), "mirror": mirror,
                            "library": lib})
    rec = {"plan_verifier": {"verify_plans_findings": len(plan_findings),
                             "kernel_plan_findings": len(kernel_findings),
                             "kernel_cases": len(cases), "cases_by_kernel": by_kernel,
                             "mirror_equal_library": len(cases) - len(unequal),
                             "host_s": host_s},
           "gpu": smi}
    emit(rec)
    if plan_findings or kernel_findings or unequal:
        raise AssertionError(f"15: {[str(f) for f in plan_findings + kernel_findings]}; "
                             f"mirrors against the libraries: {unequal}")
    return rec


def dryrun_phase(smi: str) -> dict:
    """Phase 16: each of ``DRYRUN_CELLS`` dry-run by the CLI in a process
    of its own, ``DRYRUN_AT_ONCE`` at a time, beside ``COMM_CHECK`` on
    the first cell and the one-layer cells of ``LAYER_REF``; a cell that
    fails, or whose record is not ``ok``, a number over its limit, or a
    collective count that is not ``CommDebugMode``'s, fails the phase."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}

    def run(cell):
        t = time.perf_counter()
        if cell[2:] == ("comm",):  # the check of the counter, records apart
            cmd = ["-c", COMM_CHECK, cell[0], cell[1], os.path.join(tmp, "comm")]
        elif cell[2:]:  # a one-layer cell, records apart
            cmd = ["-c", LAYER_CELL, cell[0], cell[1], os.path.join(tmp, "layer")]
        else:
            cmd = ["-m", "repro_torch.launch.dryrun", "--arch", cell[0], "--shape", cell[1],
                   "--out", tmp]
        proc = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        return cell, time.perf_counter() - t, proc

    def kinds(by_kind: dict) -> str:
        return ", ".join(f"{k} {v['count']} ({v['ring_bytes']:,} ring bytes)"
                         for k, v in sorted(by_kind.items()))

    cells, layer, layer_kinds = [], {}, {}
    try:
        with ThreadPoolExecutor(DRYRUN_AT_ONCE) as pool:
            done = list(pool.map(run, ((*DRYRUN_CELLS[0], "comm"),
                                       *((*c, "1L") for c in LAYER_REF), *DRYRUN_CELLS)))
        for (arch, shape, _), secs, proc in done[1:1 + len(LAYER_REF)]:
            if proc.returncode != 0:
                raise AssertionError(f"16: the one-layer dry run of {arch} {shape} exited "
                                     f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                                     f"{proc.stderr[-6000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            if got["status"] != "ok":
                raise AssertionError(f"16: {arch} {shape} 1L: status {got['status']!r}")
            layer[f"{arch} {shape}"] = {
                "seconds": secs, "trace_s": got["trace_s"], "torch": got["torch"],
                **{k: {"port": got[k], "reference": want, "ratio": got[k] / want,
                       "limit": LAYER_LIMITS[arch, shape][k],
                       "before": LAYER_BEFORE[arch, shape][k]}
                   for k, want in LAYER_REF[arch, shape].items()}}
            layer_kinds[f"{arch} {shape}"] = got["by_kind"]
        del done[1:1 + len(LAYER_REF)]
        (arch, shape, _), comm_secs, proc = done.pop(0)
        if proc.returncode != 0:
            raise AssertionError(f"16: the counter's check on {arch} {shape} exited "
                                 f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-6000:]}")
        comm = json.loads(proc.stdout.strip().splitlines()[-1])
        comm["seconds"] = comm_secs
        print(f"16: {arch} {shape} 16x16 beside CommDebugMode in {comm_secs:.1f} s: counter "
              f"{comm['counter']}, CommDebugMode {comm['comm_debug_mode']}", flush=True)
        for (arch, shape), secs, proc in done:
            if proc.returncode != 0:
                raise AssertionError(f"16: the dry run of {arch} {shape} exited "
                                     f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                                     f"{proc.stderr[-6000:]}")
            with open(os.path.join(tmp, f"{arch}__{shape}__16x16.json")) as f:
                rec = json.load(f)
            if rec.get("status") != "ok":
                raise AssertionError(f"16: {arch} {shape}: status {rec.get('status')!r}")
            cells.append({"arch": arch, "shape": shape, "seconds": secs,
                          "trace_s": rec["trace_s"], "torch": rec["torch"],
                          "argument_bytes": rec["memory"]["argument_bytes"],
                          "peak_bytes_est": rec["memory"]["peak_bytes_est"],
                          "ring_bytes": rec["collectives"]["ring_bytes"],
                          "flops": rec["cost"]["flops"],
                          "collectives": {k: v["count"]
                                          for k, v in rec["collectives"]["by_kind"].items()},
                          "ring_by_kind": {k: v["ring_bytes"]
                                           for k, v in rec["collectives"]["by_kind"].items()}})
            print(f"16: {arch} {shape} 16x16 ok in {secs:.1f} s: "
                  f"{proc.stdout.strip().splitlines()[-1]}; "
                  f"{kinds(rec['collectives']['by_kind'])}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mamba = next(c for c in cells if c["arch"] == "mamba2-2.7b")
    decode = {c["arch"]: c["flops"] for c in cells
              if c["shape"] == "decode_32k" and c["arch"] in DECODE_REF_FLOPS}
    vs_ref = {arch: {"port": flops, "reference": DECODE_REF_FLOPS[arch],
                     "ratio": flops / DECODE_REF_FLOPS[arch], "limit": DECODE_FLOPS_LIMIT}
              for arch, flops in decode.items()}
    mamba_ref = {"peak_bytes_est": MAMBA_PEAK_BYTES, "ring_bytes": MAMBA_RING_BYTES}
    mamba_vs = {k: {"port": mamba[k], "reference": want, "ratio": mamba[k] / want,
                    "limit": MAMBA_LIMITS[k], "before": MAMBA_BEFORE[k]}
                for k, want in mamba_ref.items()}
    train = layer.get("mamba2-2.7b train_4k")
    if train:
        train["ring_bytes_torch_2.13"] = MAMBA_TRAIN_RING_213
    rec = {"dryrun": cells, "comm_check": comm, "at_once": DRYRUN_AT_ONCE,
           "decode_flops": vs_ref, "mamba_decode": mamba_vs, "one_layer": layer,
           "one_layer_collectives": layer_kinds, "gpu": smi}
    emit(rec)
    print("16: mamba2-2.7b decode_32k 16x16 "
          + "; ".join(f"{k} {v['port']:,} (before {v['before']:,}), {v['ratio']:.3f}x the "
                      f"reference's {v['reference']:,}, limit {v['limit']}x"
                      for k, v in mamba_vs.items()), flush=True)
    for cell, got in layer.items():
        print(f"16: {cell} 16x16 1L in {got['seconds']:.1f} s: "
              + "; ".join(f"{k} {v['port']:,} (before {v['before']:,}), {v['ratio']:.3f}x the "
                          f"reference's {v['reference']:,}, limit {v['limit']}x"
                          for k, v in got.items() if isinstance(v, dict)), flush=True)
        print(f"16: {cell} 16x16 1L collectives: {kinds(layer_kinds[cell])}", flush=True)
    if train:
        ring = train["ring_bytes"]["port"]
        print(f"16: mamba2-2.7b train_4k 16x16 1L ring bytes: {ring:,} on this machine's torch "
              f"{train['torch']}, {MAMBA_TRAIN_RING_213:,} on torch 2.13 (a host CPU), "
              f"{ring / MAMBA_TRAIN_RING_213:.4f}x", flush=True)
    over = {cell: {k: v for k, v in got.items() if isinstance(v, dict)
                   and not v["ratio"] <= v["limit"]} for cell, got in layer.items()}
    if any(over.values()) or len(layer) != len(LAYER_REF):
        raise AssertionError(f"16: one-layer cells against the reference's: {json.dumps(over)}")
    over = {arch: r for arch, r in vs_ref.items() if not r["ratio"] <= DECODE_FLOPS_LIMIT}
    if over or set(decode) != set(DECODE_REF_FLOPS):
        raise AssertionError(f"16: decode_32k 16x16 FLOPs a device against the reference's "
                             f"(at most {DECODE_FLOPS_LIMIT}x): {json.dumps(vs_ref)}")
    over = {k: v for k, v in mamba_vs.items() if not v["ratio"] <= v["limit"]}
    if over:
        raise AssertionError(f"16: mamba2-2.7b decode_32k 16x16 against the reference's "
                             f"record: {json.dumps(over)}")
    if mamba["argument_bytes"] != MAMBA_ARGUMENT_BYTES:
        raise AssertionError(f"16: mamba2-2.7b decode_32k 16x16 holds {mamba['argument_bytes']} "
                             f"argument bytes; the reference's record {MAMBA_ARGUMENT_BYTES}")
    if not comm["counter"].get("all-to-all") or not (
            comm["counter"] == comm["comm_debug_mode"] == mamba["collectives"]):
        raise AssertionError(f"16: mamba2-2.7b decode_32k 16x16's collectives by kind, "
                             f"all-to-all among them: the counter {comm['counter']}, "
                             f"CommDebugMode "
                             f"{comm['comm_debug_mode']}, the CLI's record "
                             f"{mamba['collectives']}")
    return rec


def walk_phase(smi: str) -> dict:
    """Phases 15b-15d: the kernel walks against the kernels (the docstring's
    item 15)."""
    import torch
    from repro_torch.verify.dtypes import verify_dtypes
    from repro_torch.verify.kernels import kernel_cases
    from repro_torch.verify.probe import check_grid, probe_case

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = kernel_cases()
    # 15b: each C launcher's grid function against the mirror
    grids = [check_grid(c, sms) for c in cases]
    unequal = [g for g in grids if not g["equal"]]
    emit({"walk_grids": {"cases": len(grids), "equal": len(grids) - len(unequal),
                         "unequal": unequal}, "gpu": smi})
    if unequal:
        raise AssertionError(f"15b: library grids differ from the mirrors: {unequal}")
    # 15c: the write probe, case by case, each freed before the next
    t0 = time.perf_counter()
    failed = []
    for i, case in enumerate(cases):
        rec = probe_case(case, dev, seed=1000 + i, sms=sms)
        emit({"write_probe": rec, "gpu": smi})
        if not rec["ok"]:
            failed.append(rec)
    probe_s = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"15c: the write probe disagrees with the mirrors: {failed}")
    # 15d: the whole verifier in a process of its own, and the dtype policy on the card
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.verify"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"15d: python -m repro_torch.verify exited {proc.returncode}: {summary}", flush=True)
    want = "verify: 0 finding(s) across plans, kernels, lint, comm, dtypes"
    if proc.returncode != 0 or not summary.startswith(want):
        raise AssertionError(f"15d: the verifier exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    dtype_findings, dtype_verdicts = verify_dtypes(device="cuda")
    written = sorted({d for v in dtype_verdicts for d in v["kernel_written_dtypes"]})
    launched = sum(v["kernel_launches"] for v in dtype_verdicts)
    rec = {"walks": {"cases": len(cases), "grids_equal": len(grids),
                     "probes_ok": len(cases), "probe_s": probe_s,
                     "verifier": summary, "dtype_findings": len(dtype_findings),
                     "dtype_programs": [{k: v[k] for k in ("name", "accumulations",
                                                           "kernel_launches",
                                                           "kernel_written_dtypes")}
                                        for v in dtype_verdicts],
                     "dtype_kernel_launches": launched, "dtype_written": written},
           "gpu": smi}
    emit(rec)
    if dtype_findings or written != ["float32"] or launched == 0:
        raise AssertionError(f"15d: verify_dtypes on the card: {dtype_findings}, written "
                             f"{written}, {launched} launches")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve-once", metavar="DIR", default=None,
                    help="phase 11's cold or warm start: serve one bucket, building into DIR")
    ap.add_argument("--dist-rank", nargs=2, metavar=("RANK", "DIR"), default=None,
                    help="one rank of phase 14, on DIR's file store")
    ap.add_argument("--mesh-rank", metavar="DIR", default=None,
                    help="phase 9h in a process of its own, writing DIR/mesh.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.serve_once is not None:
        return serve_once(args.serve_once)
    if args.dist_rank is not None:
        return dist_rank(int(args.dist_rank[0]), args.dist_rank[1], args.seed)
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.seed)
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)  # phase 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()  # phase 2: the production build and the write probe's, at once
    built = build.build_all(probe=True)
    for source in built:
        build.library(source)
    print(f"built {len(built)} libraries and their write-probe builds in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for source, (path, log) in built.items():
        print(f"built {os.path.relpath(path, ROOT)}", flush=True)
        for line in log.splitlines():
            print(f"nvcc {source}: {line}", flush=True)
    MMA_REGS.update(parse_mma_registers(built["mttkrp.cu"][1]))
    RING_REGS.update(parse_ring_registers(built["sweep.cu"][1], "fused_pair",
                                          "fused_pair_mma_kernel"))
    RING_REGS.update(parse_ring_registers(built["multi_ttm.cu"][1], "multi_ttm_keep",
                                          "multi_ttm_mma_kernel"))
    PARTIAL_REGS.update(parse_partial_registers(built["sweep.cu"][1]))

    seconds = {"2": time.perf_counter() - t0}

    def phase(name, fn, *fn_args):
        """Run one phase; its wall time goes into ``seconds``."""
        t = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t
        return out

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    records: dict = {}
    phase("3-4", kernel_phases, gen, smi, records)
    phase("5", sweep_kernel_phases, gen, smi, records)
    main_path = phase("6", cp_phase, gen)
    matrix = phase("6b", matrix_phase, gen)
    phase("7", multi_ttm_phase, gen, smi, records)
    tucker = phase("8", tucker_phase, gen)
    phase("9a", ssd_kernel_phase, gen, smi, records)
    mamba = phase("9b-9c", mamba_phase, gen, smi)
    phase("9d", dense_phase, gen, smi)
    # Phase 9e draws from a generator of its own, so that the phases after
    # it get the inputs they had before it was added: drawing from ``gen``
    # moved phase 11's 4-way requests onto one whose direct fp32 run lies
    # 1.45e-2 from float64 in its factors, past ``SERVE_CAP`` (PERF.md,
    # section 6).
    moe_models = phase("9e", moe_phase,
                       torch.Generator(device="cuda").manual_seed(args.seed + 1), smi, records)
    # and so does phase 9f, for the same reason
    phase("9f", vlm_encdec_phase, torch.Generator(device="cuda").manual_seed(args.seed + 2), smi)
    # and so does phase 9g, the training path
    trained = phase("9g", train_phase, torch.Generator(device="cuda").manual_seed(args.seed + 3),
                    smi)
    meshed = phase("9h", mesh_phase, args.seed, smi, trained)
    batched = phase("10", batched_phase, gen, smi)
    served = phase("11", serve_phase, gen, smi)
    tuned = phase("12", tune_phase, gen, smi)
    observed = phase("13", observe_phase, gen, smi)
    distributed = phase("14", dist_phase, args.seed, smi, built)
    phase("15a", verify_phase, smi)
    phase("15b-15d", walk_phase, smi)
    phase("16", dryrun_phase, smi)
    for counted in (matrix["launches"], tucker["launches"], mamba["launches"],
                    moe_models["launches"], trained["launches"], meshed["launches"],
                    batched["launches"],
                    served["launches"], tuned["launches"],
                    observed["launches"], distributed["launches"]):
        for name, n in counted.items():
            main_path["launches"][name] += n

    main_shape = {"mttkrp3": [1000, 1000, 1000], "mttkrpn": [180, 180, 180, 180],
                  "fused_pair": [1000, 1000, 1000], "mttkrp_partial": [1000, 1000, 64],
                  "multi_ttm_keep": [1000, 1000, 1000]}
    kernels = []
    for name in KERNELS:
        # the fp32 rows, and the row of the main path's dtype where it is another
        rows = [r for r in records[name] if r["dtype"] == "float32" or r.get("main")]
        head = next((r for r in rows if r.get("main")), None) or next(
            (r for r in rows if r["shape"] == main_shape.get(name) and r.get("mode", 0) == 0),
            rows[0],
        )
        if main_path["launches"][name] == 0:
            raise AssertionError(f"{name} was never launched on the main paths")
        kernels.append({  # launches: summed over the main-path runs (CP-ALS, CP-ALS on a
            # matrix, Tucker, the Mamba2 and jamba prefills, the batched CP-ALS
            # and HOOI runs, the server's flushes, the auto runs, the traced
            # runs and the distributed ranks' runs, summed over ranks), each
            # counted from 0
            "name": name, "route": "cuda", "source": CSRC + SOURCE[name],
            "replaces": REPLACES[name],
            "launches": main_path["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            # how the three times were taken: back-to-back calls between CUDA
            # events, or (kernels of a few microseconds) launches in a CUDA graph
            "timing": head.get("timing", "cuda_events"),
        })
    emit({"phase_seconds": seconds, "total_s": time.perf_counter() - START})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
