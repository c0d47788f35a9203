#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_cc_manager_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --only-kernels  # phases 1-4: build and check kernels

Phases, each printed on its own lines; every path is driven with the launch
counts at 0 just before it and read just after:

1. device: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   and ``torch.cuda.get_device_name()``;
2. build: nvcc builds every kernel from ``tpu_cc_manager_torch/csrc``
   (registers and spills per kernel from ptxas); the f32 K1's and the simt
   K2's, K3's and K4's instances summed up (registers, spills, static
   shared memory), each without spills, and each simt flash instance
   launched once under ``torch.profiler``, its dynamic shared memory (the
   trace's, less the static) equal to its Python count
   (``fwd_simt_smem_bytes``, ``dq_simt_smem_bytes``,
   ``dkv_simt_smem_bytes``);
3. K1 (``ops/matmul.py``), its tile sweep: at bf16 4096^3, at the rows one
   card of 4 or 8 multiplies in the verify smoke (1024x4096x4096 and
   512x4096x4096) and at 1024x4096x2048, every tile of ``SM90_TILES`` (the
   wgmma kernel "sm90") against one plain result per shape, with f32 and
   with bf16 output, each with kernel time (events and ``torch.profiler``
   device time), TFLOP/s, registers and spills, beside ``torch.mm`` (events
   and device time), the plain version and the card's bound, one line per
   tile sorted by device time, the default and the fastest marked; at each of the
   verify smoke's three shapes the card's default (``default_blocks`` for
   those rows) must be the fastest tile or within the noise of it, from
   ``K1_ROUNDS`` alternating rounds of it and the three fastest; tiles
   outside the set (the two left out, one never compiled) must be refused
   before any launch; then the f32 kernel (CUDA cores, "simt"), which takes
   the caller's tiling, at each of ``K1_F32_CASES``: the JAX test's (256,
   512) x (512, 128) at (128, 128, 128), also against ``a @ b`` within that
   test's atol / rtol, 512^3 at (128, 128, 64), (64, 64, 16) and (32, 32,
   32), and 384^3 at (96, 192, 48), each against the plain version at its
   block_k, one thread-block cluster of cx x cy CTAs per caller tile (the
   cluster ``tcc_matmul_f32_cluster`` reports, ``f32_cluster``'s), so its
   grid (N / block_n * cx) x (M / block_m * cy) from the profiler's trace,
   naming the kernel that ran, with events, device time, the plain version,
   ``torch.mm`` (TF32 off), the bound at the f32 peak and that bound on the
   SMs the grid can fill;
4. K2 (``ops/flash_attention.py``) against its plain version (O and lse):
   causal and not, S = 63, 200 and 2048, D = 16, 64, 72 and 128, bf16 and
   f32, every case the simt kernel takes launched twice for the same bits;
   each case names the kernel that ran (``_variant``: bf16 at D = 64 or 128
   must take the wgmma kernel "sm90", the rest the CUDA-core kernel "simt");
   kernel / plain / SDPA / bound times and TFLOP/s at the 8B smoke's, the 1B
   training and a long shape, the simt kernel at ``entry()``'s shape, and
   the shapes phases 11-14 give it (the 8B forward's 32, 16 and 8 heads,
   the 1B step's 16 heads per rank, the 8B smoke's 16 heads per rank at
   tp = 2), and the simt kernel in f32 at the 1B training shape and at
   S = 2048, D = 128 beside SDPA's f32 forward; then K3 and K4 (the flash
   backward), over the same cases:
   gradients through the autograd Function against ``flash_backward_plain``
   on the same out and lse over the same grid, each case naming K3's and
   K4's kernels (as K2's), the simt K3 launched twice for the same bits,
   one f32 shape also against the autograd of
   ``reference_attention``; K3 / K4 kernel / plain / bound times at the 1B
   training shape, at S = 2048, D = 128 and at phase 12's 16 heads per rank,
   beside SDPA's backward alone, each also by device time from
   ``torch.profiler``, and the simt K3 and K4 at the 1B training shape and
   at S = 2048, D = 128 in f32; at each timed shape two K4 launches must
   give the same bits;
5. the matmul smoke through the agent's runner with ``--kernel torch`` and
   ``--kernel cuda`` (the latter must show K1 launches, all on "sm90", at
   the default tiling); each must report ``devices`` =
   ``torch.cuda.device_count()`` and each card's oracles; then ``--kernel
   cuda --cuda-blocks`` at phase 3's fastest tile (ok, those blocks, the
   same K1 count) and at a tile left out (one ``{"ok": false}`` line naming
   the set, exit 1, nothing launched);
6. the Llama-3-8B inference smoke at full width (32 layers, dim 4096, GQA
   32/8, vocab 128256, bf16, batch 4): all three oracles and K2 launches on
   every visible card (``devices`` and each card's oracles printed); the
   same smoke at the same width and 8 of its 32 layers (``SMOKE_CUT_LAYERS``,
   cut for time) with the cache off-by-one injected, which the transcript
   oracle must catch; then ``entry()``'s tiny forward;
7. the parallel layer, then Llama-3.2-1B training on it: ``bootstrap()``
   must be the single-process no-op, ``make_mesh(MeshSpec())`` builds a
   one-rank NCCL mesh (its five sizes printed) and ``verify_dcn_mesh`` must
   hold; then the 1B model at full width (16 layers, dim 2048, GQA 32/8,
   vocab 128256; f32 parameters, bf16 compute, flash attention, AdamW)
   through ``make_llama_train_state(cfg, mesh)`` (FSDP2 at one rank):
   8 steps on one fixed batch of 4 x 1024 tokens; the loss must be finite
   and strictly decreasing, each step must launch K2, K3 and K4 once per
   layer (all on their sm90 kernels), the first 3 steps rerun on
   fresh state must repeat every printed digit of the loss, and the flash
   path's gradient must match the einsum path's on the same weights;
   ms/step (beside the one-device step's time before FSDP2), tokens/s, MFU,
   peak memory and one profiled step;
8. the ResNet-50 training smoke through the agent's runner at full width
   (224², 1000 classes, batch 64 per card, bf16 activations, f32
   parameters): ok, one rank on every visible card (``devices`` and each
   rank's loss printed), valid timing and a falling loss; images/s, s/step,
   MFU and the FLOPs it counted; then one more step in this process under
   ``torch.profiler``: device time by kernel group and the idle share;
9. a checkpoint round trip on the ResNet-50 train state with cuDNN
   deterministic: 2 steps, save, 2 more steps (losses A); a fresh state
   from another seed, restored, must equal the saved one in every
   parameter, buffer, momentum and the step, and its 2 steps (losses B)
   must repeat A bit for bit; bytes written, save and restore seconds;
10. ring attention (``ops/ring_attention.py``): each rank's forward and
   backward code run on this card by n = 2 and n = 4 threads, one per
   virtual rank, each on its own CUDA stream, exchanging K/V through an
   in-memory ring with a barrier in place of the process group's
   ``batch_isend_irecv``; bf16, GQA 32/8, D = 64, at the Llama-3.2-1B
   training shape (4, 32, 1024, 64) and a long-context (1, 32, 8192, 64).
   The ranks' outputs, joined, must match the plain reference attention on
   the whole sequence with K/V repeated (f32, on the same bf16 inputs)
   within K2's bf16 tolerance, and dq, dk, dv its autograd gradient within
   K3/K4's; the ring launches none of K1-K4. Each rank's forward and
   backward ms (CUDA events on its stream, waits included) and the ring's
   device time over all ranks (``torch.profiler``), beside K2 + K3 + K4 and
   SDPA on the whole sequence;
11. tensor parallelism on virtual ranks (``parallel/tensor.py``): Llama-3-8B
   at full width and depth (bf16 weights from seed 0, flash on, batch
   4 x 1024, forward only under ``inference_mode``), first at tp = 1, then
   at tp = 2 and 4 with one thread per tp rank on its own CUDA stream, each
   holding ``shard_state_dict``'s shard of the tp = 1 weights and exchanging
   through an in-memory ``all_reduce``/``all_gather`` (events, a barrier,
   ``record_stream``) in place of ``GroupTP``. Every rank's joined logits
   must be the same, within 5e-2 of max|ref| of the tp = 1 forward, with the
   last position's argmax margin within the transcript limit; each forward
   launches 32 K2 per rank, all ``sm90``, on the rank's 32/tp heads. Per-rank
   forward ms (events), the device time of one forward over all ranks beside
   the tp = 1 forward's (``torch.profiler``), and K2 at each local-head shape
   beside SDPA (phase 4's table). The autograd engine runs one device's
   backward on one shared thread, so threads cannot run the backward;
12. the train step at ``{tp: 2}`` in two processes on this one card over a
   gloo group (NCCL refuses two ranks of one communicator on one GPU; gloo
   stages CUDA tensors through the host): 3 Llama-3.2-1B steps from seed 0
   on phase 7's batch, through ``make_llama_train_state`` /
   ``make_llama_train_step``; both ranks' losses must be equal and within
   1e-3 of phase 7's first three, with 16 ``sm90`` launches each of K2/K3/K4
   per step on each rank; step seconds and peak memory per rank; then the
   same run with ``copy_to_tp`` dropped (no column-parallel input's
   gradient summed over tp), whose losses must miss that limit;
13. the Llama-3-8B smoke as one tp = 2 group, as a 4-card node runs each of
   its groups: two processes on this card over gloo, each calling the
   per-rank function the runner's workers call (``verify_replica`` with
   ``tp=2``: its head shard, ``GroupTP`` over the pair), at Llama-3-8B's
   width and 8 of its 32 layers (``SMOKE_CUT_LAYERS``, cut for time),
   batch 4, prompt 32, decode 4 (phase 6's 32 cut for time). All three
   oracles must pass on both ranks, the ranks must agree token for token
   (``combine_ranks``), and each rank's no-cache forward must launch one
   ``sm90`` K2 a layer on its 16 heads at (4, 16, 35, 128); then the same
   with the cache off-by-one, which the
   transcript oracle must catch. Its transcript margin is printed beside
   phase 6's, its ms/token labelled gloo host staging (not NCCL);
14. the Hugging Face loader at Llama-3.2-1B width: an HF-layout state dict
   (``(out, in)`` bf16 tensors from a seed, tied, no ``lm_head.weight``) and
   a ``SimpleNamespace`` with HF's field names and llama3 rope scaling,
   converted onto the card by ``config_from_hf`` + ``hf_state_dict_to_params``
   (seconds and the peak host RSS printed: no f32 copy of the model); the
   same weights through this script's own numpy transpose and
   ``params_from_jax`` must be the same tensors, and the flash forward of a
   4 x 1024 batch on each must give the same logits, bit for bit (``wq`` and
   ``wo`` are square, so only the logits catch a missed transpose);
15. the device layer (``tpu_cc_manager_torch/gpudev``) on the card, which
   it never flips or resets: real discovery (the sysfs PCI scan, NVML's
   GPUs, names, UUIDs and system CC state, torch's BDFs by
   ``torch_index_by_bdf``), which must agree wherever the machine answers
   (a sandboxed kernel may show no PCI bus in sysfs, and NVML may refuse PCI
   information: each refusal is printed with its code); then ``H100Backend``
   flips the card's BDF off -> on -> devtools -> off through the stand-in
   gpu-admin-tools (``gpudev/standin_admin.py``, copied under
   ``build/chip_smoke_gpudev/``), an NVML CC state that follows it, and a
   stand-in sysfs tree where the real one has no PCI bus; each step must
   keep the reference's order (every set, then every reset, then every
   wait_for_boot) and verify, with its seconds by phase. After ``on`` the
   matmul smoke with ``--kernel cuda`` verifies the card (ok, K1 on
   ``sm90`` only, the card's BDF in ``per_device``); ``ppcie`` must be
   refused by the all-devices rule (one card, no NVSwitch); the real card's
   ``fetch_attestation`` must be refused by NVML (CC off, its return code
   printed), and NVML's CC state must end as it started. Discovery and
   NVML query ms are printed beside the ``nvidia-smi`` line;
16. the port's agent (``tpu_cc_manager_torch/ccmanager``) on the card:
   (a) in this process, ``CCManager`` over the port's ``FakeKube`` with the
   operator's component pods on the node (drained and re-admitted on every
   flip), flipping off -> on -> off twice: over phase 15's stand-in rig
   (``H100Backend`` behind ``ccmanager/node.py``, the manager's own
   verifier), where the flip to on must fail at its attestation (NVML
   refuses the report with CC off), before its smoke, and leave the card's
   CC state as it was; then over the port's fake node with fake quotes
   admitted. Every other flip that changes the mode (h100 off, fake on,
   fake off) is verified by K1's matmul smoke on the card (``--kernel
   cuda``, all on ``sm90``). Each flip's result, wall and phase seconds
   (``tpu_cc_phase_seconds``) and label tuples are printed, and the label
   sequence must be the JAX agent's (``AGENT_LABELS``). (b)
   ``python -m tpu_cc_manager_torch --gpu-backend fake --smoke-workload
   matmul`` as a process against ``hack/mock_apiserver.py``
   (``ccmanager/localrig.py``): the desired label set to on, the seconds
   until the node reads ``mode.state=on`` and ``ready.state=true``
   (drain->ready, beside the 90 s budget and the ``nvidia-smi`` line) and
   the agent's own phase seconds from ``/metrics``; SIGTERM must exit 0;
17. a rolling CC flip of a pool on the card (``rolling_pool``): two fake HGX
   H100 nodes (8 GPUs and 4 NVSwitches each, ``FakeGpuBackend`` behind
   ``NodeBackend``, the operator's pods from ``drain/sim.py``), each a port
   ``CCManager.watch_and_apply`` on a thread over one port ``FakeKube``,
   each verifying its flip with K1's matmul smoke on the card (``--kernel
   cuda``). The port's ``RollingReconfigurator`` flips the pool to on with
   ``max_unavailable=1``, a ``RolloutLease`` and a ``FlightRecorder``; it is
   killed (``OrchestratorKilled``) at the first window boundary, after group
   1 converged, and a successor takes the lease over (a higher generation),
   reads the ``RolloutRecord`` and resumes. The result must be ok, every
   node committed and labelled on and ready, never two nodes out of service
   or two smokes at once, one smoke per node with phase 5's K1 count, all
   ``sm90``, no torn flight line, each node converged once in the
   reconstructed timeline, and one patch through the killed orchestrator's
   ``FencedKube`` refused and counted. The pool wall, each node's desired
   -> ready wall against the 90 s budget, its smoke share and the takeover
   gap are printed;
18. a federated CC flip of two regions through the port's operator CLI
   (``federated_pool``): one fake HGX H100 node per region (``r1``, ``r2``,
   the federation's region label), each an agent as in phase 17, flipped to
   on by ``ctl.cmd_rollout`` with ``--regions r1,r2`` and a failure budget
   of one node: one lease-fenced orchestrator shard per region under one
   parent record. ctl's orchestrator is wrapped so that the r1 shard is
   killed at its first parent exchange (``federation-boundary``), before
   it touched its node; ``rollout --resume --regions r1,r2`` resumes its
   record. The result must be ok, both nodes committed and labelled on and
   ready, one smoke per node with phase 5's K1 count, all ``sm90``, the
   resumed shard's record bound to the parent's digest, the parent record
   complete with each region's node counted once and no budget spent, one
   patch through the killed shard's ``FencedKube`` refused and counted;
   ``ctl rollout-timeline --stitch`` over the two regional flight files
   must render, with 0 torn lines and each node converged once; a
   ``FleetGateway`` over the two agents' registries (``local_target``)
   serves ``/metrics``, whose ``tpu_cc_phase_seconds`` ``_count`` and
   ``_sum`` must equal the nodes' sums and which ``lint/expo.py`` must
   pass, and ``/fleetz``, listing both nodes fresh; ``ctl status`` must
   list both nodes on. The pool wall, each node's desired -> ready wall
   against the 90 s budget and its smoke share, the takeover gap, the
   gateway's sweep and the phase's wall are printed;
19. the agent as its DaemonSet starts it (``tpu_cc_manager_torch/deploy/``,
   read with ``deploy``'s line readers, no YAML parser): (a) the image's
   build step, the Dockerfile's ``python -m tpu_cc_manager_torch.ops._build
   --dir DIR`` against a copy of the package laid out as the image lays it
   out under ``build/chip_smoke_image/``, with nvcc's seconds per library,
   then ``DIR`` made read-only (0555); (b) ``python -m tpu_cc_manager_torch``
   as the container starts it (the image's entrypoint and env, the
   manifest's env, every hostPath under that directory,
   ``TPU_CC_CACHE_DIR`` an empty writable directory there) against
   ``hack/mock_apiserver.py``, only ``GPU_CC_BACKEND=fake`` and the metrics
   port (a free one) changed: the liveness probe's ``/healthz`` answers, one
   flip to on must be ready within the 90 s budget with one verify smoke,
   the smoke's default kernel, K1, on every card with phase 5's K1 count,
   all ``sm90``, loaded from the read-only directory (no library written
   anywhere else, the directory unchanged), the fake's lines in the agent's
   log must show the CC ready state set once after the attestation, and
   SIGTERM exit 0;
   (c) the manifest's ``h100`` backend over phase 15's stand-ins, the agent
   on a thread, its spans in a trace file: the flip to on must fail closed
   at the attestation, the node labelled failed with its reason, the agent
   alive, NVML's ready state and CC state unchanged and no set call (the
   setter is refused), and the trace must hold one ``reset.chip`` span per
   GPU under the reconcile's trace id; once as the card answers (NVML
   refuses the report, CC off: no quote, no ``attest.verify``), once with a
   stand-in report, unsigned and with no certificate chain, which the
   verifier must refuse in one ``attest.verify`` span with problems >= 1;
20. a training job through a CC flip by the drain handshake
   (``job_through_flip``): against ``hack/mock_apiserver.py``, a job
   process (``python -m tpu_cc_manager_torch.ccmanager.localrig job``)
   trains Llama-3.2-1B at its published width and depth (phase 7's
   configuration, seed and batch) and holds at step 3; the sidecar
   ``python -m tpu_cc_manager_torch.ctl drain-subscribe`` (its
   ``--on-drain`` asks the job to checkpoint through ``TrainCheckpointer``
   and waits for its exit, its ``--on-resume`` starts a job that restores
   the newest checkpoint and trains to step 8); the agent CLI with the fake
   device layer, its matmul smoke, ``CC_DRAIN_ACK_TIMEOUT_S`` and
   ``CC_TRACE_FILE``. The desired label is set to on. The checkpoint must
   land before any component pause and the job must have exited before the
   first reset (the trace file's spans), the node must be on and ready
   within the 90 s budget, one verify smoke with phase 5's K1 count on
   every card, all ``sm90``, the losses of both jobs must be phase 7's at
   every printed digit, each step must launch K2/K3/K4 once per layer on
   ``sm90``, and ``attest.verify`` must sit under the reconcile's trace id.
   The checkpoint's bytes, save and restore seconds, the handshake's wait,
   drain->ready with its phase seconds and the job's downtime are printed;
21. the node bench on the card (``tpu_cc_manager_torch/bench/``, the port of
   the repository's ``bench.py``, ``bench_ab.py`` and
   ``hack/smoke_cache_bench.py``), each as a process: (a) ``python -m
   tpu_cc_manager_torch.bench.bench`` with ``CC_BENCH_REALISTIC_RUNS=1``
   must be ok and under the 90 s target, its smokes on ``cuda``; its
   drain->ready, wall vs serialized sum, phase histograms and the cold vs
   warm smoke (the cold child building the K1 library into a fresh
   directory, the warm one building none) are printed; (b) ``--spare``
   must be ok, the prestaged spare's flip under its pool-mate's full path,
   and whether the two smoke windows overlapped is printed; (c)
   ``bench_ab --workloads matmul --reps 2 --cycles 1``: both arms on the
   card (both CC off: the fake device layer), the loss with its 95% CI
   half-width printed;
22. one ``{"kernels": [...]}`` JSON line, one entry per kernel, variant and
   timed shape that the script checks against its plain version, each
   marked ``on_path`` when a path launched it (the f32 K1 and the simt K3
   and K4 run on no path; the ResNet and ring paths run none of K1-K4: the
   ResNet's convolutions are cuDNN's, as the JAX package's are XLA's, and
   the ring's blocks are plain PyTorch, as the JAX ring's are XLA einsums),
   then the ``nvidia-smi`` line;
23. last line ``{"ok": true, "device": {...}}``.

Before phases 12, 13, 20 and 21, which start processes on this card, the
script prints what its own process still holds there. Every verify smoke
of phases 15-21 must report K1 at the default tiling for its card and
size (``default_blocks``), with phase 5's K1 count.

Any failed phase exits non-zero before the last line. Without CUDA, or run
outside the repository, it fails at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

K1_TOL = 1e-4  # rel. to max|plain|: only the f32 summation order differs
# K1 with bf16 output: both sides round one f32 value to bf16 (as K2_TOL).
K1_BF16_TOL = 1e-2
# (M, K, N) of the sweep: the verify smoke's product on 1, 4 and 8 cards
# (4096, 1024 and 512 rows a card), where the default is checked, and a
# product whose N differs from K.
K1_SHAPES = ((4096, 4096, 4096), (1024, 4096, 4096), (512, 4096, 4096), (1024, 4096, 2048))
K1_ROUNDS = 9  # alternating timing rounds of the default tile and the fastest
K1_ROUND_LAUNCHES = 50  # launches a round, timed by their device time
# The default may trail the fastest tile by the noise: the interquartile
# range of the round-by-round ratio of their device times, at least the
# floor and at most the cap, so that a default 5% slower than the fastest
# always fails. That range measured 0.0014-0.0052 of the median on an H100
# 80GB HBM3 (PERF.md §6); the floor keeps two tiles less than 2% apart, such
# as (256, 128, 64) and (128, 256, 64) at 1024 rows (0.6%), from trading
# places between runs and failing one.
K1_NOISE_FLOOR = 0.02
K1_NOISE_CAP = 0.05
# (M, K, N, blocks) of the f32 K1 ("simt"), which takes the caller's tiling:
# tests/test_ops.py::TestTiledMatmul's case, then 512^3 at KERNEL_BLOCKS,
# at the kernel's old fixed tile, below its 64 x 64 thread layout, and 384^3
# at a divisor that is no power of two.
K1_F32_CASES = ((256, 512, 128, (128, 128, 128)), (512, 512, 512, (128, 128, 64)),
                (512, 512, 512, (64, 64, 16)), (512, 512, 512, (32, 32, 32)),
                (384, 384, 384, (96, 192, 48)))
# The reference test's own tolerance against a @ b (f32, TF32 off).
K1_F32_REF_ATOL, K1_F32_REF_RTOL = 1e-3, 1e-5
# K2's O, relative to max|plain O|: both sides round the same f32 value to
# bf16, so they differ by at most one bf16 ulp, which is at most 2^-7 of a
# value; in f32 only the summation order differs.
K2_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
LSE_TOL = 1e-4  # lse is f32 on both sides
# K3/K4's dq, dk, dv, relative to max|plain|: in f32 only the summation order
# differs; in bf16 both sides round one f32 value to bf16 once.
K34_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Head dims of phase 4's correctness loops: the simt kernels' 16 and 72 (no
# power of two), the sm90 kernels' 64 and 128 in bf16 (simt in f32).
K_HEAD_DIMS = (16, 64, 72, 128)
TRANSCRIPT_LIMIT = 1e-2  # the Llama smoke's argmax margin (smoke/llama_infer.py)
# The 1B training phase: batch x sequence, steps, and the flash-vs-einsum
# gradient limit (the Llama smoke's flash limit).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
TRAIN_GRAD_LIMIT = 5e-2
DETERMINISM_STEPS = 3  # rerun on fresh state; the losses must repeat
# The 1B step on one device before the state was sharded with FSDP2 (one
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's.
ONE_DEVICE_STEP_MS = 336.51
FIRST_LOSS = 12.261904  # the 1B step's first loss: same weights, same forward
RESNET_BATCH = 64
CHECKPOINT_STEPS = 2  # steps before the save, and after it on each side
# Ring attention: virtual ranks, and (B, H, S, D) at the 1B model's heads
# (GQA 32/8, D = 64): its training shape and a long context.
RING_SIZES = (2, 4)
RING_SHAPES = ((4, 32, 1024, 64), (1, 32, 8192, 64))
RING_KV_HEADS = 8
RING_BARRIER_TIMEOUT_S = 300
# Tensor parallelism on virtual ranks: Llama-3-8B forwards of batch x
# sequence tokens at each tp, the joined logits' limit relative to max|ref|
# of the tp = 1 forward (the Llama smoke's flash-vs-einsum limit; only the
# bf16 rounding of the row-parallel partial sums differs).
TP_SIZES = (2, 4)
TP_BATCH, TP_SEQ = 4, 1024
TP_LOGIT_LIMIT = 5e-2
TP_BARRIER_TIMEOUT_S = 300
# Two processes on the one card at {tp: 2} over gloo: Llama-3.2-1B train
# steps, held against phase 7's one-rank losses. bf16 compute rounds the
# row-parallel sums differently: sound runs differ by up to 1.3e-4; the
# limit sits between that and a planted fault (``GLOO_TP_FAULT``), which
# must exceed it.
GLOO_TP = 2
GLOO_TP_STEPS = 3
GLOO_TP_LOSS_TOL = 1e-3
GLOO_TP_TIMEOUT_S = 600
# The planted fault: Megatron's f dropped (``copy_to_tp`` the identity both
# ways), so no column-parallel input's gradient is summed over the tp ranks.
GLOO_TP_FAULT = "no-copy-to-tp"
# The Llama smoke (phase 6's) as one tp = GLOO_TP group in GLOO_TP processes
# on this card over gloo; each rank runs it clean, then with the cache
# off-by-one.
SMOKE_SIZE = "llama3-8b"
# Phase 6's decode of 32 is cut to 4 here: over gloo on one card a decode
# step took 0.13-0.35 s (an H100 80GB HBM3 at 700 W), and the smoke's timed
# decode alone runs 20 x decode steps, so 32 took 455 s for both runs.
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_DECODE = 4, 32, 4
SMOKE_HEADS, SMOKE_HEAD_DIM = 32, 128  # Llama-3-8B's
# Phase 13's runs and phase 6's run with the cache off-by-one keep
# Llama-3-8B's width and cut its depth to SMOKE_CUT_LAYERS of 32: the tp
# group's exchange, the oracles and the fault are the same at any depth, and
# the script passed 900 s once phase 21 came (phase 13 took 99 s at full
# depth, 41 s at 8 layers, on an H100 80GB HBM3 at 700 W).
SMOKE_CUT_LAYERS = 8
GLOO_SMOKE_TIMEOUT_S = 600
# The Hugging Face loader at the published Llama-3.2-1B geometry (its
# config.json's fields), tied embeddings, and the batch of its forward.
HF_1B_CONFIG = dict(
    vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
    num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=131072,
    rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
    rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
HF_BATCH, HF_SEQ = 4, 1024

# Phase 16, the port's agent on the card. Its node, with the operator's
# component pods on it, and the flips each pass makes.
AGENT_NODE = "chip-smoke-node"
AGENT_NS = "tpu-operator"
AGENT_FLIPS = ("off", "on", "off")
# The labels followed on the node: mode state, ready state, failed reason
# and the device plugin's deploy label (paused while the node drains).
AGENT_LABEL_KEYS = ("cloud.google.com/tpu-cc.mode.state", "cloud.google.com/tpu-cc.ready.state",
                    "cloud.google.com/tpu-cc.failed.reason",
                    "google.com/tpu.deploy.device-plugin")
_PAUSED = "paused-for-tpu-cc-mode-change"
# Each pass's distinct label tuples per flip, as the JAX agent gives them on
# the CPU (tests/test_torch_agent_manager.py holds both agents to these): the
# components come back before the state label is written. On
# the card's H100Backend the flip to on fails at its attestation: NVML
# refuses the report with CC off, a device error, so the reason is the one
# the manager gives every device error (``apply-failed``).
AGENT_LABELS = {
    "h100": [[("off", "false", None, "true")],
             [("off", "false", None, _PAUSED), ("failed", "", "apply-failed", _PAUSED),
              ("failed", "", "apply-failed", "true")],
             [("failed", "", "apply-failed", _PAUSED), ("failed", "", "apply-failed", "true"),
              ("off", "false", None, "true")]],
    "fake": [[("off", "false", None, "true")],
             [("off", "false", None, _PAUSED), ("off", "false", None, "true"),
              ("on", "true", None, "true")],
             [("on", "true", None, _PAUSED), ("on", "true", None, "true"),
              ("off", "false", None, "true")]],
}
AGENT_BUDGET_S = 90.0  # drain->ready per node, the north star (BASELINE.md)
AGENT_FLIP_TIMEOUT_S = 180
AGENT_PHASES = ("drain", "stage", "reset", "wait_ready", "attest", "smoke", "readmit")

# Phase 17, a rolling CC flip of a pool on the card: two fake HGX H100
# nodes, flipped to on one node at a time by the port's orchestrator. The
# first orchestrator is killed at the first window boundary, after group 1
# converged; a successor takes the lease over once it lapses and resumes.
# Four nodes (the host count of BASELINE.json configs[3], a v5p-32 node
# pool) until phase 18 took two of its verify smokes: the K1 launches of a
# run stay what they were.
POOL_NODES = 2
POOL_LABEL = ("pool", "chip-smoke")
POOL_LEASE_S = 3.0  # lease duration: bounds the takeover gap
POOL_NODE_TIMEOUT_S = 180
POOL_KILL_POINT = "window-boundary"

# Phase 18, a federated CC flip of two regions on the card through the
# port's operator CLI (``ctl.cmd_rollout --regions``): one fake HGX H100
# node per region, a failure budget of one node over both. The r1 shard is
# killed at its first parent exchange (``federation-boundary``, before it
# touched a node) and resumed by ``rollout --resume --regions``.
FED_REGIONS = ("r1", "r2")
FED_LABEL = ("pool", "chip-smoke-fed")
FED_KILL_REGION = "r1"
FED_KILL_POINT = "federation-boundary"
FED_BUDGET = 1

# Phase 20, a training job through a CC flip on the card: Llama-3.2-1B at
# its published width and depth trains phase 7's batch from phase 7's seed
# beside the agent CLI; the sidecar ``ctl drain-subscribe`` asks it to
# checkpoint when the agent drains the node, and starts a job that restores
# the checkpoint once the node is back. The first job holds at
# ``JOB_HOLD_AT`` until the drain; the resumed one trains to phase 7's last
# step, and its losses must be phase 7's.
JOB_SUBSCRIBER = "train"
JOB_HOLD_AT = 3
JOB_ACK_TIMEOUT_S = 300  # the agent's CC_DRAIN_ACK_TIMEOUT_S: above the save
JOB_TIMEOUT_S = 600  # a job's start, restore and steps, or its hold
JOB_SUB_POLL_S = 0.2  # the sidecar's drain poll (idle polls 5x)


# Phase 2's count of f32 K1 and simt K2, K3, K4 instances: 8 each (element
# type x vec, and K1's k chunk or the flash kernels' NQ).
SIMT_INSTANCES = 32
# The kernel variants the paths driven must launch (K2's simt in entry()).
PATH_VARIANTS = {"K1/sm90", "K2/sm90", "K2/simt", "K3/sm90", "K4/sm90"}
# Phase 21, the node bench on the card (tpu_cc_manager_torch/bench/): its
# realistic drain->ready runs (CC_BENCH_REALISTIC_RUNS, 3 by default, cut to
# 1 for time), the A/B's reps and cycles, and each command's limit.
BENCH_REALISTIC_RUNS = 1
AB_REPS, AB_CYCLES = 2, 1
BENCH_TIMEOUT_S = 400
# The launch counts of a path, every kernel and variant.
COUNT_KEYS = ("K1", "K2", "K3", "K4", "K1/sm90", "K1/simt", "K2/sm90", "K2/simt", "K3/sm90",
              "K3/simt", "K4/sm90", "K4/simt")


def cut_smoke_size() -> str:
    """Register Llama-3-8B at ``SMOKE_CUT_LAYERS`` layers as a size of the
    Llama smoke in this process; returns its name."""
    from tpu_cc_manager_torch.models.llama import LlamaConfig
    from tpu_cc_manager_torch.smoke import llama_infer

    name = f"{SMOKE_SIZE}, {SMOKE_CUT_LAYERS} layers"
    llama_infer.SIZES[name] = lambda **kw: LlamaConfig.llama3_8b(n_layers=SMOKE_CUT_LAYERS, **kw)
    return name


def fail(message: str) -> None:
    """Print the failure on both streams (a caller that keeps only one of
    them still sees why) and exit 1."""
    print(f"FAIL: {message}", flush=True)
    print(f"FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(message: str) -> None:
    print(message, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    import torch

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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float | None:
    """Mean device time of one ``fn()``: the CUDA kernels' own time under
    ``torch.profiler`` over ``iters`` calls, so host work between them (an
    autograd engine's, say) does not count. None if the profiler saw no
    device time in two traces (one trace of the 4 us simt K2 at entry()'s
    shape once came back without kernel events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                       if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation)
        if total_us > 0:
            return total_us / 1e3 / iters
    return None


class PhaseClock:
    """Wall seconds of each phase, printed as it ends, and of the script."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def lap(self, label: str) -> None:
        now = time.perf_counter()
        say(f"wall: {label} {now - self.last:.1f} s (script {now - self.start:.1f} s)")
        self.last = now


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def fmt_bytes(n: int | None) -> str:
    return "not in the trace" if n is None else f"{n} bytes"


def free_thread_workspaces(torch) -> None:
    """Hand back what the virtual ranks' threads left on the card. cuBLAS
    keeps a 32 MiB workspace for every (handle, stream) pair it has served,
    for the life of the process, and each was carved from whatever cached
    segment was free: phases 10 and 11's threads, each on streams of its own,
    left 1.45 GB of them pinning 8.21 GB of segments on an H100 80GB HBM3."""
    import gc

    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()


def bound_ms(flops: float, nbytes: float, peak_flops: float, peak_bw: float):
    """(least time in ms, what bounds it) for the work on this card."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_report(log: str, pattern: str) -> dict[tuple, dict]:
    """Registers, spill bytes and static shared memory of every kernel whose
    mangled name matches ``pattern``, from nvcc's ``-Xptxas -v`` output, by
    the pattern's groups: {"registers", "spill_stores", "spill_loads",
    "smem"}."""
    import re

    report, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            m = re.search(pattern, line)
            entry = None if m is None else report.setdefault(m.groups(), {"smem": 0})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(m.group(1)) if m else 0
    return report


def sm90_tile_report(log: str) -> dict[tuple, dict]:
    """The sm90 K1 kernels' ``ptxas_report`` by (tile, out dtype). The
    f32-output kernel is the smoke's."""
    found = ptxas_report(log, r"mm_sm90_kernelILi(\d+)ELi(\d+)ELi(\d+)E(f|13__nv_bfloat16)E")
    return {(tuple(int(g) for g in k[:3]), "f32" if k[3] == "f" else "bf16"): v
            for k, v in found.items()}


SIMT_FLASH = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def simt_name(name: str, dtype: str, nq: str | None, vec: str, kc: str | None = None) -> str:
    """One f32 K1 or simt flash instance's name in phase 2's report."""
    args = [dtype] + ([f"D {'<= 64' if nq == '1' else '72-128'}"] if nq else [])
    args += [f"vec {vec}"] + ([f"k chunk {kc}"] if kc else [])
    return f"{name}<{', '.join(args)}>"


def simt_kernel_report(log: str) -> dict[str, dict]:
    """The f32 K1's (``mm_f32_kernel``) and the simt K2's, K3's and K4's
    (``SIMT_FLASH``) ``ptxas_report`` by instance."""
    found = ptxas_report(log, rf"(mm_f32_kernel|{'|'.join(SIMT_FLASH)})I(f|13__nv_bfloat16)"
                              r"(?:Li(\d+)E)?Lb([01])E(?:Li(\d+)E)?")
    return {simt_name(name, "f32" if dtype == "f" else "bf16", nq, vec, kc): v
            for (name, dtype, nq, vec, kc), v in found.items()}


def simt_flash_launches(torch) -> dict[str, dict]:
    """Launch every simt K2, K3 and K4 instance once, through the wrappers,
    under ``torch.profiler``: f32 and bf16 at D = 16 and 72 (NQ = 1 and 2),
    each with inputs on 16 bytes and one element off them (vec 1 and 0).
    Returns, by instance (``simt_kernel_report``'s names), the D it ran at,
    the count of its Python twin for that D, and the trace's shared memory
    (static and dynamic) and registers per thread, or None where the trace
    has no such field."""
    import re

    from tpu_cc_manager_torch.ops import flash_attention as fa

    twins = {"flash_fwd_kernel": fa.fwd_simt_smem_bytes,
             "flash_bwd_dq_kernel": fa.dq_simt_smem_bytes,
             "flash_bwd_dkv_kernel": fa.dkv_simt_smem_bytes}
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(dtype, D, off) for dtype in (torch.float32, torch.bfloat16) for D in (16, 72)
             for off in (0, 1)]

    def tensors(dtype, D, off):
        shape = (1, 2, 100, D)
        return [torch.randn(200 * D + off, generator=gen, device="cuda", dtype=dtype)[off:]
                [:200 * D].view(shape) for _ in range(4)]

    inputs = [tensors(*case) for case in cases]

    def run():
        for q, k, v, g in inputs:
            out, lse = fa.flash_forward(q, k, v, True)
            delta = fa.attention_delta(out, g)
            fa.flash_backward_dq(q, k, v, g, lse, delta, True)
            fa.flash_backward_dkv(q, k, v, g, lse, delta, True)

    pattern = re.compile(rf"({'|'.join(SIMT_FLASH)})<(float|__nv_bfloat16), (\d), (true|false)>")
    found = {}
    def instances(events):  # 8 = 2 dtypes x 2 head dims x 2 alignments a kernel
        return {m.groups() for m in map(pattern.search, (e.get("name", "") for e in events)) if m}

    for event in kernel_events(torch, run,
                               lambda events: len(instances(events)) == 8 * len(SIMT_FLASH)):
        m = pattern.search(event.get("name", ""))
        if m is None:
            continue
        name, dtype, nq, vec = m.groups()
        size = 4 if dtype == "float" else 2
        D = 16 if nq == "1" else 72
        args = event.get("args", {})
        instance = simt_name(name, "f32" if size == 4 else "bf16", nq, str(int(vec == "true")))
        found[instance] = {"D": D, "python_count": twins[name](D, size),
                           "trace_smem": args.get("shared memory"),
                           "trace_registers": args.get("registers per thread")}
    return found


def k1_case(torch, a, b, blocks, ref, expected: str, out_dtype=None) -> tuple:
    """K1 at ``blocks`` on the card against the plain result ``ref`` (f32,
    rounded to ``out_dtype`` as the plain version rounds it): (max abs
    error, error relative to max|ref|, the variant that ran, ok)."""
    from tpu_cc_manager_torch.ops.matmul import tiled_matmul

    out_dtype = out_dtype or torch.float32
    out, (variant,) = ran_variants(
        [tiled_matmul], lambda: tiled_matmul(a, b, *blocks, out_dtype=out_dtype))
    torch.cuda.synchronize()
    err = float((out.float() - ref.to(out_dtype).float()).abs().max())
    rel = err / float(ref.abs().max())
    tol = K1_TOL if out_dtype == torch.float32 else K1_BF16_TOL
    ok = (bool(torch.isfinite(out).all()) and out.dtype == out_dtype and rel <= tol
          and variant == expected)
    return err, rel, variant, ok


def check_k1(torch, peaks, variant: str) -> dict:
    """Phase 3: K1's tile sweep. Every compiled sm90 tile at each of
    ``K1_SHAPES`` against one plain result per shape, with f32 and with
    bf16 output, each timed (events and device time) beside ``torch.mm``
    and the bound; at the verify smoke's shapes the card's default for
    those rows must be the fastest tile or within the noise; tiles outside
    the set must be refused before any launch; then the f32 simt kernel at
    each tiling of ``K1_F32_CASES`` (``check_k1_f32``). Returns the default
    tile's timed cases at 4096^3 and 1024x4096x2048 and the simt cases (the
    kernels line) and the sweep."""
    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.ops import _build
    from tpu_cc_manager_torch.ops.matmul import (
        SM90_LEFT_OUT,
        SM90_TILES,
        default_blocks,
        tiled_matmul,
        tiled_matmul_plain,
    )

    say(f"K1 sm90 tiles: {len(SM90_TILES)} {[list(t) for t in SM90_TILES]}; left out "
        f"{json.dumps({str(list(t)): why for t, why in SM90_LEFT_OUT.items()})}")
    regs = sm90_tile_report(_build.build_log("matmul"))

    gen = torch.Generator(device="cuda").manual_seed(1)
    timed, sweep, problems = [], {}, []
    for M, K, N in K1_SHAPES:
        a = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
        b = torch.randn((K, N), generator=gen, device="cuda", dtype=torch.bfloat16)
        ref = tiled_matmul_plain(a, b, 64)
        plain = time_ms(lambda: tiled_matmul_plain(a, b, 64), iters=5, warmup=1)
        lib_event = time_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
        lib_dev = device_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
        flops = 2.0 * M * N * K
        b_ms, b_by = bound_ms(flops, (M * K + K * N) * 2 + M * N * 4, peaks["bf16"], peaks["bw"])
        rows = []
        for tile in SM90_TILES:
            if M % tile[0] or N % tile[1] or K % tile[2]:
                continue
            err, rel, ran, ok = k1_case(torch, a, b, tile, ref, "sm90")
            err16, rel16, ran16, ok16 = k1_case(torch, a, b, tile, ref, "sm90", torch.bfloat16)
            if not (ok and ok16):
                fail(f"K1 [{ran}, {ran16}, want sm90] at blocks {tile} disagrees with its plain "
                     f"version at {M}x{K}x{N}: rel_err={rel:.3e} (tol {K1_TOL:g}), with bf16 "
                     f"output {rel16:.3e} (tol {K1_BF16_TOL:g})")
            ms = time_ms(lambda: tiled_matmul(a, b, *tile))
            dev = device_ms(lambda: tiled_matmul(a, b, *tile))
            rows.append(dict(blocks=list(tile), max_abs_err=err, rel_err=rel,
                             bf16_rel_err=rel16, ms=ms, device_ms=dev,
                             tflops=flops / ms / 1e9, **regs.get((tile, "f32"), {}),
                             bf16_out=regs.get((tile, "bf16"), {})))
        # By the kernels' own time: back to back, a small shape's launches
        # outpace the host, and events would time the host.
        rows.sort(key=lambda r: r["ms"] if r["device_ms"] is None else r["device_ms"])
        default = list(default_blocks(variant, min(M, N, K), rows=M))
        say(f"K1 sweep {M}x{K}x{N} bf16 -> f32 ({len(rows)} tiles, each within {K1_TOL:g} of "
            f"one plain result, and with bf16 output within {K1_BF16_TOL:g}): "
            f"torch.mm_ms={lib_event:.4f} (device {fmt_ms(lib_dev)}) plain_ms={plain:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        for i, r in enumerate(rows):
            marks = [m for m, on in (("fastest", i == 0), ("default", r["blocks"] == default))
                     if on]
            say(f"K1 tile {tuple(r['blocks'])} {M}x{K}x{N}: kernel_ms={r['ms']:.4f} (device "
                f"{fmt_ms(r['device_ms'])}) tflops={r['tflops']:.1f} x torch.mm "
                f"{r['ms'] / lib_event:.3f} bound_ms={b_ms:.4f} rel_err={r['rel_err']:.3e} "
                f"bf16_out_rel_err={r['bf16_rel_err']:.3e} registers={r.get('registers')} "
                f"spill_stores={r.get('spill_stores')} spill_loads={r.get('spill_loads')} "
                f"(bf16 out: {r['bf16_out'].get('registers')} / "
                f"{r['bf16_out'].get('spill_stores')}) {' '.join(marks)}")
        by_tile = {tuple(r["blocks"]): r for r in rows}
        if tuple(default) not in by_tile:
            fail(f"the default tile {default} at {M}x{K}x{N} is not a compiled tile")
        shape = f"{M}x{K}x{N}"
        sweep[shape] = dict(rows=rows, library_ms=lib_event, library_device_ms=lib_dev,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, default=default)
        if N == K == 4096:  # the verify smoke's product on 1, 4 or 8 cards
            gate = check_default_tile(a, b, rows, default, variant)
            sweep[shape]["gate"] = gate
            if gate.get("problem"):
                problems.append(gate["problem"])
        if M == N == K or N != K:  # the kernels line's two K1 shapes
            d = by_tile[tuple(default)]
            timed.append(dict(variant="sm90", shape=[M, K, N], blocks=default,
                              max_abs_err=d["max_abs_err"], ms=d["ms"],
                              device_ms=d["device_ms"], plain_ms=plain, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib_event if lib_dev is None else lib_dev,
                              library_event_ms=lib_event, library_call="torch.mm"))
        del a, b, ref
    if problems:
        fail("; ".join(problems))

    # Tiles outside the compiled set: refused before any launch, by name.
    a = torch.zeros((512, 512), device="cuda", dtype=torch.bfloat16)
    for tile in (*SM90_LEFT_OUT, (128, 128, 32)):
        before = ops.variant_launch_counts()["K1"]
        try:
            tiled_matmul(a, a, *tile)
            fail(f"K1 launched the tile {tile}, which is not compiled")
        except ValueError as e:
            named = str(list(SM90_TILES)) in str(e) and \
                (tile not in SM90_LEFT_OUT or SM90_LEFT_OUT[tile] in str(e))
            say(f"K1 tile {tile}: refused before the launch: {str(e)[-160:]}")
            if not named or ops.variant_launch_counts()["K1"] != before:
                fail(f"K1's refusal of {tile} did not name the set and the reason, or launched")

    return {"timed": timed, "simt": check_k1_f32(torch, peaks, gen), "sweep": sweep}


def kernel_events(torch, fn, complete, tries: int = 3) -> list[dict]:
    """The kernel events of a ``torch.profiler`` trace of ``fn()``: each
    kernel's name and its args (grid, block, registers per thread, shared
    memory, ...). A trace for which ``complete(events)`` is false is taken
    again, up to ``tries`` traces in all, and the last one is returned: the
    profiler on the card has now and then returned a trace without the
    kernel events of the launches it held."""
    import pathlib
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f).get("traceEvents", [])
        events = [e for e in events if e.get("cat") == "kernel" or "grid" in e.get("args", {})]
        if complete(events):
            break
        say(f"torch.profiler trace {attempt + 1} of {tries}: {len(events)} kernel events, "
            f"not the launches sought")
    return events


def launch_grid(torch, fn, kernel: str) -> list | None:
    """The grid of ``kernel``'s one launch in ``fn()``, from a
    ``torch.profiler`` trace (its kernel events carry the grid), or None
    when the trace holds none."""
    def grids(events):
        return [e["args"]["grid"] for e in events
                if kernel in e.get("name", "") and "grid" in e.get("args", {})]

    found = grids(kernel_events(torch, fn, lambda events: len(grids(events)) == 1))
    return found[0] if len(found) == 1 else None


def k1_cluster(M: int, N: int, blocks) -> tuple[int, int]:
    """The cluster ``tcc_matmul_f32_cluster`` reports for ``blocks``; it
    must be ``ops/matmul.py::f32_cluster``'s and cover one caller tile
    exactly (cy rows of cx CTAs, each (block_m / cy) x (block_n / cx))."""
    import ctypes

    from tpu_cc_manager_torch.ops import _build
    from tpu_cc_manager_torch.ops.matmul import f32_cluster

    cx, cy = ctypes.c_int(), ctypes.c_int()
    rc = _build.load("matmul").tcc_matmul_f32_cluster(M, N, blocks[0], blocks[1],
                                                       ctypes.byref(cx), ctypes.byref(cy))
    got = (cx.value, cy.value)
    if rc != 0 or got != f32_cluster(M, N, blocks[0], blocks[1]) or \
            blocks[0] % got[1] or blocks[1] % got[0] or got[0] * got[1] > 16:
        fail(f"K1 [simt] at {M}x{N} and blocks {blocks}: the C entry's cluster {got} (rc {rc}) "
             f"is not f32_cluster's {f32_cluster(M, N, blocks[0], blocks[1])}, or does not "
             f"cover one caller tile exactly")
    return got


def check_k1_f32(torch, peaks, gen) -> list[dict]:
    """Phase 3's f32 K1 ("simt"), which no path runs, at the caller's
    tiling: each case of ``K1_F32_CASES`` against the plain version at its
    block_k (``K1_TOL``), the reference test's case also against ``a @ b``
    within its own atol / rtol, each launch's grid (from the profiler's
    trace) exactly one cluster of cx x cy CTAs per caller tile, (N / block_n
    * cx) x (M / block_m * cy) with the cluster the C entry reports, and
    each timed (events and device time) beside the plain version,
    ``torch.mm`` (TF32 off), the bound at the f32 peak, and that bound on
    only the SMs the launch's CTAs can fill (the grid-capped bound), for
    this grid and for one CTA per caller tile."""
    from tpu_cc_manager_torch.ops.matmul import tiled_matmul, tiled_matmul_plain

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for M, K, N, blocks in K1_F32_CASES:
        a = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.float32)
        b = torch.randn((K, N), generator=gen, device="cuda", dtype=torch.float32)
        ref = tiled_matmul_plain(a, b, blocks[2])
        err, rel, ran, ok = k1_case(torch, a, b, blocks, ref, "simt")
        shape = f"{M}x{K}x{N}"
        if (M, K, N, blocks) == K1_F32_CASES[0]:
            out = tiled_matmul(a, b, *blocks)
            mm = a @ b
            ref_err = float((out - mm).abs().max())
            ref_ok = bool(torch.allclose(out, mm, atol=K1_F32_REF_ATOL, rtol=K1_F32_REF_RTOL))
            say(f"K1 [simt] {shape} at {blocks} against a @ b (tests/test_ops.py): max_abs_err="
                f"{ref_err:.3e} (atol {K1_F32_REF_ATOL:g}, rtol {K1_F32_REF_RTOL:g}) "
                f"{'ok' if ref_ok else 'MISMATCH'}")
            ok = ok and ref_ok
        cx, cy = k1_cluster(M, N, blocks)
        tiles = (N // blocks[1]) * (M // blocks[0])
        grid = launch_grid(torch, lambda: tiled_matmul(a, b, *blocks), "mm_f32_kernel")
        want_grid = [N // blocks[1] * cx, M // blocks[0] * cy, 1]
        ms = time_ms(lambda: tiled_matmul(a, b, *blocks))
        dev = device_ms(lambda: tiled_matmul(a, b, *blocks))
        plain = time_ms(lambda: tiled_matmul_plain(a, b, blocks[2]), iters=5, warmup=1)
        lib_event = time_ms(lambda: torch.mm(a, b))
        lib_dev = device_ms(lambda: torch.mm(a, b))
        flops = 2.0 * M * N * K
        b_ms, b_by = bound_ms(flops, (M * K + K * N + M * N) * 4, peaks["f32"], peaks["bw"])
        # The bound when only min(CTAs, SMs) SMs can work: the FMAs of the
        # busiest SMs at their share of the peak.
        capped = {n: b_ms * sms / min(n, sms) for n in (tiles * cx * cy, tiles)}
        say(f"K1 [{ran}] {shape} float32 at blocks {blocks}: cluster {cx} x {cy}, grid "
            f"{grid if grid is not None else 'not measured'} (want {want_grid}) max_abs_err="
            f"{err:.3e} rel_err={rel:.3e} (tol {K1_TOL:g}) kernel_ms={ms:.4f} (device "
            f"{fmt_ms(dev)}) plain_ms={plain:.4f} torch.mm_ms={lib_event:.4f} (device "
            f"{fmt_ms(lib_dev)}, TF32 off) bound_ms={b_ms:.5f} ({b_by}) grid-capped bound_ms="
            f"{capped[tiles * cx * cy]:.5f} at {tiles * cx * cy} CTAs ({capped[tiles]:.5f} at "
            f"one CTA a tile) tflops={flops / ms / 1e9:.2f} {'ok' if ok else 'MISMATCH'}")
        if not ok or grid is None or list(grid) != want_grid:
            fail(f"K1 [{ran}, want simt] at {shape} and blocks {blocks}: disagrees with its "
                 f"plain version or the reference, or launched the grid {grid}, not {want_grid}")
        cases.append(dict(variant="simt", shape=[M, K, N], blocks=list(blocks), max_abs_err=err,
                          ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_event if lib_dev is None else lib_dev,
                          library_event_ms=lib_event, library_call="torch.mm (f32, TF32 off)",
                          grid=grid, cluster=[cx, cy],
                          grid_capped_bound_ms=capped[tiles * cx * cy],
                          one_cta_a_tile_bound_ms=capped[tiles]))
        del a, b, ref
    return cases


def check_default_tile(a, b, rows, default, variant) -> dict:
    """The card's default tile for ``a @ b`` against the sweep: the default
    and the sweep's three fastest tiles timed again in ``K1_ROUNDS``
    alternating rounds of ``K1_ROUND_LAUNCHES`` launches, by the kernels'
    device time (at 512 rows a kernel runs shorter than the host takes to
    launch it, so events would time the host). Each round gives
    the ratio of the default's time to each tile's, so that a clock or
    power state that spans a round moves both alike. The rival is the tile
    with the highest median ratio; the default must not trail it by more
    than the noise, the interquartile range of that ratio over its median,
    at least ``K1_NOISE_FLOOR`` and at most ``K1_NOISE_CAP``. Returns the
    times, the rival, the noise and, if the default trails, the problem."""
    import statistics

    from tpu_cc_manager_torch.ops.matmul import DEFAULT_BLOCKS, tiled_matmul

    shape = f"{a.shape[0]}x{a.shape[1]}x{b.shape[1]}"
    if variant not in DEFAULT_BLOCKS:
        say(f"K1 default at {shape}: no measured DEFAULT_BLOCKS entry for {variant!r}; the "
            f"fallback {default} ran")
        return {}
    d = tuple(default)
    tiles = [tuple(r["blocks"]) for r in rows[:3]]
    tiles += [d] if d not in tiles else []
    times = {t: [] for t in tiles}
    for _ in range(K1_ROUNDS):
        for t in tiles:
            ms = device_ms(lambda: tiled_matmul(a, b, *t), iters=K1_ROUND_LAUNCHES, warmup=1)
            if ms is None:
                return {"problem": f"the profiler saw no device time for K1 {t} at {shape}"}
            times[t].append(ms)
    ratios = {t: [x / y for x, y in zip(times[d], times[t])] for t in tiles if t != d}
    median = {t: statistics.median(v) for t, v in ratios.items()}
    # The default's closest rival, and the spread of their ratio over its median.
    rival = max(median, key=median.get)
    q = statistics.quantiles(ratios[rival], n=4)
    iqr = (q[2] - q[0]) / median[rival]
    noise = min(K1_NOISE_CAP, max(K1_NOISE_FLOOR, iqr))
    fastest = rival if median[rival] > 1 else d
    spread = {str(list(t)): [round(statistics.median(v), 5), round(min(v), 5), round(max(v), 5)]
              for t, v in times.items()}
    say(f"K1 default {d} ({variant}) at {shape} against the sweep's fastest, {K1_ROUNDS} "
        f"alternating rounds of {K1_ROUND_LAUNCHES} launches: median device ms (min-max) "
        f"{json.dumps(spread)}; default / tile, median by round "
        f"{json.dumps({str(list(t)): round(m, 4) for t, m in median.items()})}; fastest "
        f"{fastest}; noise {noise:.4f} (the interquartile range of the ratio to {rival}, "
        f"{iqr:.4f} of its median; floor {K1_NOISE_FLOOR:g}, cap {K1_NOISE_CAP:g})")
    out = dict(tiles={str(list(t)): v for t, v in times.items()}, fastest=list(fastest),
               rival=list(rival), default_over_rival=median[rival], iqr=iqr, noise=noise)
    if median[rival] > 1 + noise:
        out["problem"] = (f"the default {d} for {variant} at {shape} is not the fastest tile "
                          f"nor within the noise: {median[rival]:.4f}x the time of {rival} "
                          f"(noise {noise:.4f})")
    return out


def tiling_problem(res: dict) -> str | None:
    """Why a matmul smoke result does not report K1 at the default tiling
    for its card, size and rows a card (``default_blocks``), or None."""
    from tpu_cc_manager_torch.ops.matmul import default_blocks

    size = res.get("size") or 0
    want = list(default_blocks(res.get("generation"), size,
                               rows=size // (res.get("devices") or 1)))
    if res.get("kernel") != "cuda" or res.get("blocks") != want:
        return (f"the smoke ran {res.get('kernel')} at blocks {res.get('blocks')}, not K1 at "
                f"the default {want} for {res.get('generation')} at size {res.get('size')}")
    return None


def check_cuda_blocks_cli(winner: list, smoke_k1: int) -> dict:
    """``python -m tpu_cc_manager_torch.smoke --workload matmul --kernel cuda
    --cuda-blocks`` as a child: at the sweep's fastest tile it must pass and
    report those blocks with ``smoke_k1`` sm90 launches; at a tile left out
    it must print one ``{"ok": false}`` line naming the set and exit 1
    before any launch (the refusal comes before the kernel library is even
    loaded). Returns the passing run's launch counts."""
    from tpu_cc_manager_torch.ops.matmul import SM90_LEFT_OUT
    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

    arg = ",".join(str(b) for b in winner)
    t0 = time.perf_counter()
    try:
        res = run_workload_subprocess("matmul", timeout_s=300,
                                      extra_args=["--kernel", "cuda", "--cuda-blocks", arg])
    except SmokeError as e:
        fail(f"matmul smoke --cuda-blocks {arg}: {e}")
    launches = {**res["kernel_launches"], **flat_variants(res["kernel_launches_by_variant"])}
    say(f"matmul smoke --cuda-blocks {arg}: ok={res['ok']} blocks={res['blocks']} "
        f"size={res['size']} tflops={res['tflops']} mfu={res['mfu']} K1 sm90="
        f"{launches['K1/sm90']} simt={launches['K1/simt']}; child wall "
        f"{time.perf_counter() - t0:.2f} s")
    if res["blocks"] != winner or launches["K1/sm90"] != smoke_k1 or launches["K1/simt"]:
        fail(f"matmul smoke --cuda-blocks {arg} reported blocks {res['blocks']} with K1 "
             f"{launches}, want {winner} with {smoke_k1} on sm90")
    refused = next(iter(SM90_LEFT_OUT))
    arg = ",".join(str(b) for b in refused)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_cc_manager_torch.smoke", "--workload", "matmul",
         "--kernel", "cuda", "--cuda-blocks", arg],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    say(f"matmul smoke --cuda-blocks {arg}: rc={proc.returncode} {proc.stdout.strip()[-300:]}")
    if proc.returncode != 1 or len(lines) != 1 or last.get("ok") is not False or \
            "compiled for the tiles" not in last.get("error", ""):
        fail(f"matmul smoke --cuda-blocks {arg} was not refused on one line with rc 1: "
             f"rc={proc.returncode} {proc.stdout[-1000:]} {proc.stderr[-1000:]}")
    return launches


def expected_variant(dtype, D: int) -> str:
    """The K2/K3/K4 kernel that inputs of this dtype and head dim must take."""
    import torch

    return "sm90" if dtype == torch.bfloat16 and D in (64, 128) else "simt"


def ran_variants(fns, call):
    """``call()``'s result and, for each wrapper in ``fns`` (each with
    ``launches_by_variant``), the variant of the one launch it made."""
    before = [dict(fn.launches_by_variant) for fn in fns]
    result = call()
    variants = []
    for fn, counts in zip(fns, before):
        ran = [v for v, n in fn.launches_by_variant.items() if n != counts[v]]
        if len(ran) != 1:
            fail(f"{fn.__name__} made {ran} launches by variant, want exactly one")
        variants.append(ran[0])
    return result, variants


def check_k2(torch, peaks) -> dict:
    import torch.nn.functional as F

    from tpu_cc_manager_torch.ops.flash_attention import flash_forward, flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(B, H, S, D, dtype):
        return [torch.randn((B, H, S, D), generator=gen, device="cuda", dtype=dtype)
                for _ in range(3)]

    def compare(q, k, v, causal) -> tuple[float, str]:
        """Hold K2 against its plain version on (q, k, v); fail on a
        mismatch of O or lse, or if the wrong kernel ran. Returns O's max
        abs error and the variant that ran."""
        B, H, S, D = q.shape
        dtype = str(q.dtype)[6:]
        (out, lse), (variant,) = ran_variants([flash_forward],
                                              lambda: flash_forward(q, k, v, causal))
        ref, ref_lse = flash_forward_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        tol = K2_TOL[dtype]
        want = expected_variant(q.dtype, D)
        ok = (bool(torch.isfinite(out).all()) and rel <= tol and lse_err <= LSE_TOL
              and variant == want)
        repeat = ""
        if variant == "simt":
            # One summation order and no atomics: a second launch, the same bits.
            again, again_lse = flash_forward(q, k, v, causal)
            same = torch.equal(out, again) and torch.equal(lse, again_lse)
            ok = ok and same
            repeat = f"; two launches {'bitwise equal' if same else 'DIFFER'}"
        say(f"K2 [{variant}] B={B} H={H} S={S} D={D} causal={causal} {dtype}: O "
            f"max_abs_err={err:.3e} rel_err={rel:.3e} (tol {tol:g}) lse max_abs_err="
            f"{lse_err:.3e} (tol {LSE_TOL:g}){repeat} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K2 [{variant}, want {want}] disagrees with its plain version or itself "
                 f"(B={B} H={H} S={S} D={D} causal={causal} {dtype})")
        return err, variant

    for causal in (True, False):
        for S in (63, 200, 2048):
            for D in K_HEAD_DIMS:
                for dtype in (torch.bfloat16, torch.float32):
                    compare(*inputs(2, 4, S, D, dtype), causal)

    timed = []
    # The Llama-3-8B smoke's no-cache forward (oracle 3), the Llama-3.2-1B
    # training forward, a long sequence, entry()'s tiny forward (D = 16, the
    # simt kernel), the 8B forward of phase 11 on its 32, 16 and 8 heads per
    # rank (tp = 1, 2, 4), phase 12's 1B step on its 16 heads per rank, then
    # phase 13's 8B smoke on its 16 heads per rank (the no-cache forward of
    # its transcript, prompt + decode - 1 tokens). Phase 14's 1B forward is
    # the 1B training shape.
    for B, H, S, D in ((4, 32, 63, 128), (4, 32, 1024, 64), (1, 32, 2048, 128), (2, 4, 16, 16),
                       *((TP_BATCH, 32 // n, TP_SEQ, 128) for n in (1, *TP_SIZES)),
                       (TRAIN_BATCH, 32 // GLOO_TP, TRAIN_SEQ, 64),
                       (SMOKE_BATCH, SMOKE_HEADS // GLOO_TP, SMOKE_PROMPT + SMOKE_DECODE - 1,
                        SMOKE_HEAD_DIM)):
        q, k, v = inputs(B, H, S, D, torch.bfloat16)
        err, variant = compare(q, k, v, True)
        ms = time_ms(lambda: flash_forward(q, k, v, True))
        # The kernel's own time: at the small shapes the events may time the
        # host's launch rate instead.
        dev = device_ms(lambda: flash_forward(q, k, v, True))
        plain = time_ms(lambda: flash_forward_plain(q, k, v, True), iters=5, warmup=1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        flops = 4.0 * B * H * D * S * (S + 1) / 2  # causal: S(S+1)/2 pairs
        nbytes = 4.0 * B * H * S * D * q.element_size() + B * H * S * 4
        b_ms, b_by = bound_ms(flops, nbytes, peaks["bf16"], peaks["bw"])
        say(f"K2 [{variant}] timing B={B} H={H} S={S} D={D} bf16 causal: "
            f"kernel_ms={ms:.4f} (device {fmt_ms(dev)}) plain_ms={plain:.4f} sdpa_ms={lib:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) tflops={flops / ms / 1e9:.1f}")
        timed.append(dict(variant=variant, shape=[B, H, S, D], max_abs_err=err, ms=ms,
                          device_ms=dev, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib))
    # The simt K2 in f32, which no path runs, at the 1B training shape and at
    # S = 2048, D = 128, beside SDPA's f32 forward, against the f32 peak.
    for B, H, S, D in ((4, 32, 1024, 64), (1, 32, 2048, 128)):
        q, k, v = inputs(B, H, S, D, torch.float32)
        err, variant = compare(q, k, v, True)
        ms = time_ms(lambda: flash_forward(q, k, v, True))
        dev = device_ms(lambda: flash_forward(q, k, v, True))
        plain = time_ms(lambda: flash_forward_plain(q, k, v, True), iters=3, warmup=1)
        lib_event = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        lib_dev = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        flops = 4.0 * B * H * D * S * (S + 1) / 2
        b_ms, b_by = bound_ms(flops, 4.0 * B * H * S * D * 4 + B * H * S * 4, peaks["f32"],
                              peaks["bw"])
        say(f"K2 [{variant}] timing B={B} H={H} S={S} D={D} float32 causal: kernel_ms={ms:.4f} "
            f"(device {fmt_ms(dev)}) plain_ms={plain:.4f} sdpa_ms={lib_event:.4f} (device "
            f"{fmt_ms(lib_dev)}, f32) bound_ms={b_ms:.5f} ({b_by}) tflops={flops / ms / 1e9:.2f}")
        timed.append(dict(variant=variant, shape=[B, H, S, D], dtype="float32",
                          max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_event if lib_dev is None else lib_dev,
                          library_event_ms=lib_event, library_call="SDPA forward (f32)"))
        del q, k, v
    return timed


def check_k3_k4(torch, peaks) -> tuple[dict, dict]:
    import torch.nn.functional as F

    from tpu_cc_manager_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)

    def inputs(B, H, S, D, dtype):
        return [torch.randn((B, H, S, D), generator=gen, device="cuda", dtype=dtype)
                for _ in range(4)]

    def compare(q, k, v, g, causal) -> tuple[dict, list]:
        """Gradients through the autograd Function (K2, then K3 and K4)
        against flash_backward_plain on the kernel's own out and lse; fail on
        a mismatch or if the wrong K3 or K4 ran. Returns each gradient's max
        abs error and K3's and K4's variants."""
        B, H, S, D = q.shape
        dtype = str(q.dtype)[6:]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal)
        grads, variants = ran_variants([fa.flash_backward_dq, fa.flash_backward_dkv],
                                       lambda: torch.autograd.grad(out, leaves, g))
        with torch.no_grad():
            out, lse = fa.flash_forward(q, k, v, causal)
            refs = fa.flash_backward_plain(q, k, v, out, lse, g, causal)
            if variants[0] == "simt":
                # One summation order and no atomics: two launches, the same bits.
                args = (q, k, v, g, lse, fa.attention_delta(out, g), causal)
                same = torch.equal(fa.flash_backward_dq(*args), fa.flash_backward_dq(*args))
        torch.cuda.synchronize()
        tol = K34_TOL[dtype]
        want = expected_variant(q.dtype, D)
        errs, parts, ok = {}, [], variants == [want, want]
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            err = float((got.float() - ref.float()).abs().max())
            rel = err / float(ref.float().abs().max())
            ok = ok and got.dtype == q.dtype and bool(torch.isfinite(got).all()) and rel <= tol
            errs[name] = err
            parts.append(f"{name} max_abs_err={err:.3e} rel_err={rel:.3e}")
        repeat = ""
        if variants[0] == "simt":
            ok = ok and same
            repeat = f"; K3 two launches {'bitwise equal' if same else 'DIFFER'}"
        ran = f"K3 {variants[0]}, K4 {variants[1]}"
        say(f"K3/K4 [{ran}] B={B} H={H} S={S} D={D} causal={causal} {dtype}: "
            f"{' '.join(parts)} (tol {tol:g}){repeat} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K3/K4 [{ran}, want {want}] disagree with flash_backward_plain or K3 "
                 f"with itself (B={B} H={H} S={S} D={D} causal={causal} {dtype})")
        return errs, variants

    for causal in (True, False):
        for S in (63, 200, 2048):
            for D in K_HEAD_DIMS:
                for dtype in (torch.bfloat16, torch.float32):
                    compare(*inputs(2, 4, S, D, dtype), causal)

    # Cross-check at one f32 shape: the plain reference's own autograd.
    q, k, v, g = (t.requires_grad_(True) for t in inputs(2, 4, 2048, 64, torch.float32))
    got = torch.autograd.grad(fa.flash_attention(q, k, v, True), (q, k, v), g)
    want = torch.autograd.grad(fa.reference_attention(q, k, v, True), (q, k, v), g)
    rels = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want)]
    say(f"K3/K4 vs autograd of reference_attention B=2 H=4 S=2048 D=64 f32 causal: "
        f"rel_err dq={rels[0]:.3e} dk={rels[1]:.3e} dv={rels[2]:.3e} (tol {K34_TOL['float32']:g})")
    if max(rels) > K34_TOL["float32"]:
        fail("K3/K4 disagree with the autograd of reference_attention")
    del q, k, v, g, got, want

    timed3, timed4 = [], []
    # The Llama-3.2-1B training step's attention, a long sequence, then
    # phase 12's 1B step on its 16 heads per rank, in bf16 (the sm90
    # kernels); then the training shape and the long one in f32, the simt
    # kernels, which no path runs, timed against the f32 peak.
    bf16, f32 = torch.bfloat16, torch.float32
    for B, H, S, D, dtype in ((4, 32, 1024, 64, bf16), (1, 32, 2048, 128, bf16),
                              (TRAIN_BATCH, 32 // GLOO_TP, TRAIN_SEQ, 64, bf16),
                              (4, 32, 1024, 64, f32), (1, 32, 2048, 128, f32)):
        q, k, v, g = inputs(B, H, S, D, dtype)
        peak = peaks["bf16"] if dtype == bf16 else peaks["f32"]
        errs, (v3, v4) = compare(q, k, v, g, True)
        out, lse = fa.flash_forward(q, k, v, True)
        delta = fa.attention_delta(out, g)
        args = (q, k, v, g, lse, delta, True)
        # One summation order and no atomics: two launches, the same bits.
        first, again = fa.flash_backward_dkv(*args), fa.flash_backward_dkv(*args)
        same = all(torch.equal(x, y) for x, y in zip(first, again))
        say(f"K4 [{v4}] B={B} H={H} S={S} D={D} {str(dtype)[6:]}: two launches "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            fail(f"K4 [{v4}] gave other dK or dV bits on a second launch")
        del first, again
        k3_ms = time_ms(lambda: fa.flash_backward_dq(*args))
        k4_ms = time_ms(lambda: fa.flash_backward_dkv(*args))
        k3_dev = device_ms(lambda: fa.flash_backward_dq(*args))
        k4_dev = device_ms(lambda: fa.flash_backward_dkv(*args))
        k3_plain = time_ms(lambda: fa.flash_backward_dq_plain(*args), iters=3, warmup=1)
        k4_plain = time_ms(lambda: fa.flash_backward_dkv_plain(*args), iters=3, warmup=1)
        # Yardstick only (the port never calls SDPA): SDPA's backward alone,
        # on one graph kept for every call; by CUDA events (host work of the
        # autograd engine included) and by its kernels' device time.
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)

        def sdpa_bwd_call():
            return torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True)

        sdpa_event = time_ms(sdpa_bwd_call)
        sdpa_dev = device_ms(sdpa_bwd_call)
        sdpa_bwd = sdpa_event if sdpa_dev is None else sdpa_dev
        pairs = B * H * S * (S + 1) / 2  # causal (query, key) pairs
        lse_delta_bytes = 2 * B * H * S * 4
        k3_bound = bound_ms(3 * 2.0 * D * pairs, 5.0 * B * H * S * D * q.element_size()
                            + lse_delta_bytes, peak, peaks["bw"])
        k4_bound = bound_ms(4 * 2.0 * D * pairs, 6.0 * B * H * S * D * q.element_size()
                            + lse_delta_bytes, peak, peaks["bw"])
        say(f"K3/K4 timing B={B} H={H} S={S} D={D} {str(dtype)[6:]} causal: "
            f"K3 [{v3}] kernel_ms={k3_ms:.4f} (device {fmt_ms(k3_dev)}) "
            f"plain_ms={k3_plain:.4f} bound_ms={k3_bound[0]:.5f} ({k3_bound[1]}) tflops="
            f"{3 * 2.0 * D * pairs / k3_ms / 1e9:.1f}; K4 [{v4}] kernel_ms={k4_ms:.4f} "
            f"(device {fmt_ms(k4_dev)}) plain_ms={k4_plain:.4f} bound_ms={k4_bound[0]:.5f} "
            f"({k4_bound[1]}) tflops={4 * 2.0 * D * pairs / k4_ms / 1e9:.1f}; K3+K4 "
            f"{k3_ms + k4_ms:.4f} ms against sdpa_backward_ms={sdpa_event:.4f} (device "
            f"{fmt_ms(sdpa_dev)}; dq, dk, dv together, backward alone)")
        common = dict(shape=[B, H, S, D], dtype=str(dtype)[6:], library_ms=sdpa_bwd,
                      library_event_ms=sdpa_event,
                      library_call="SDPA backward (dq, dk, dv)")
        timed3.append(dict(variant=v3, max_abs_err=errs["dq"], ms=k3_ms, device_ms=k3_dev,
                           plain_ms=k3_plain, bound_ms=k3_bound[0], bound_by=k3_bound[1],
                           **common))
        timed4.append(dict(variant=v4, max_abs_err=max(errs["dk"], errs["dv"]), ms=k4_ms,
                           device_ms=k4_dev, plain_ms=k4_plain, bound_ms=k4_bound[0],
                           bound_by=k4_bound[1], **common))
        del q, k, v, g, out, lse, delta, leaves, sdpa_out
    return timed3, timed4


def flat_variants(by_variant: dict) -> dict:
    """``ops.variant_launch_counts()`` as flat ``"K2/sm90"``-style keys."""
    return {f"{k}/{v}": n for k, counts in by_variant.items() for v, n in counts.items()}


def k2_launches(n: int) -> dict:
    """The counts of a path that launches ``n`` K2, all on its sm90 kernel,
    and nothing else."""
    counts = dict.fromkeys(("K1", "K3", "K4", "K1/sm90", "K1/simt", "K2/simt", "K3/sm90",
                            "K3/simt", "K4/sm90", "K4/simt"), 0)
    return {**counts, "K2": n, "K2/sm90": n}


def check_devices(label: str, res: dict, want: int) -> None:
    """A smoke result must cover ``want`` cards, each one passing."""
    cards = res.get("per_device") or []
    if res["devices"] != want or len(cards) != want or not all(c["ok"] for c in cards):
        fail(f"{label}: devices={res['devices']} with {len(cards)} per-card results, want "
             f"{want}, each passing")


def grad_rel_err(got: dict, want: dict, names) -> float:
    """||got - want|| / ||want|| over the named gradients taken together."""
    num = sum(float((got[n].float() - want[n].float()).pow(2).sum()) for n in names)
    den = sum(float(want[n].float().pow(2).sum()) for n in names)
    return (num / den) ** 0.5


# Device-time groups of a training step, by kernel name (first match wins).
LLAMA_KERNEL_GROUPS = (
    ("K2 flash forward", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("K3 flash dQ", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel")),
    ("K4 flash dK/dV", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sgemm")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("softmax", ("softmax",)),
    ("FSDP2 collectives and copies", ("nccl", "chunk_cat", "split_with_sizes",
                                      "catarraybatchedcopy")),
)
RESNET_KERNEL_GROUPS = (
    ("convolution (cuDNN)", ("xmma", "conv", "cudnn", "implicit_gemm", "dgrad", "wgrad",
                             "fprop", "nhwc", "nchw")),
    # cuDNN runs some 1x1 convolutions as GEMMs; the classifier is one too.
    ("GEMM kernels (1x1 convolutions, the classifier)", ("gemm", "nvjet")),
    ("batch norm statistics (reductions)", ("reduce_kernel",)),
    ("SGD (foreach)", ("multi_tensor_apply",)),
    ("max pool", ("max_pool",)),
    ("elementwise (batch norm normalise, ReLU, casts, residual adds)", ("elementwise",)),
    ("DDP (NCCL)", ("nccl",)),
)


def profile_step(torch, label: str, run_step, groups) -> None:
    """``run_step()`` (one train step that waits for its loss) under
    torch.profiler, neither timed nor counted with the others: device time
    by kernel group and the top kernels, and the device's busy share of the
    step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = {}
    for evt in prof.key_averages():
        # Kernels only: a CPU op, and a user annotation's range on the device
        # timeline, carry the time of the kernels inside them too.
        if (evt.device_type == DeviceType.CUDA and not evt.is_user_annotation
                and evt.self_device_time_total > 0):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
    busy = sum(by_kernel.values())
    by_group = {}
    for name, ms in by_kernel.items():
        group = next((g for g, keys in groups
                      if any(key in name.lower() for key in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
    say(f"{label} profile (one extra step): wall_ms={wall_ms:.2f} device_busy_ms={busy:.2f} "
        f"idle_share={1 - busy / wall_ms:.4f}; by group ms: "
        + json.dumps({g: round(ms, 3) for g, ms in sorted(by_group.items(), key=lambda x: -x[1])}))
    for name, ms in sorted(by_kernel.items(), key=lambda x: -x[1])[:12]:
        say(f"{label} profile kernel: {ms:9.3f} ms  {name[:140]}")


def check_parallel_layer():
    """bootstrap, make_mesh and verify_dcn_mesh on this one card; returns
    the one-rank mesh."""
    import torch.distributed as dist

    from tpu_cc_manager_torch.parallel.distributed import bootstrap, verify_dcn_mesh
    from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh, mesh_sizes

    info = bootstrap()
    if info != {"processes": 1, "initialized": False}:
        fail(f"bootstrap() in one process returned {info}, want the single-process no-op")
    mesh = make_mesh(MeshSpec())
    t0 = time.perf_counter()
    verified = verify_dcn_mesh(mesh)  # the first collective on each data axis's group
    say(f"parallel: bootstrap {info}; mesh {mesh_sizes(mesh)} on {mesh.device_type} "
        f"(backend {dist.get_backend()}, world {dist.get_world_size()}); "
        f"verify_dcn_mesh {verified} in {time.perf_counter() - t0:.2f}s")
    if "nccl" not in dist.get_backend() or not verified:
        fail("the one-rank mesh is not on NCCL, or verify_dcn_mesh failed")
    return mesh


def train_llama_1b(torch, peaks, mesh) -> dict:
    """The training slice's main path at Llama-3.2-1B full width on the
    mesh: 8 AdamW steps on one fixed batch with K2/K3/K4 in every layer,
    then the flash path's gradient against the einsum path's on the same
    weights."""
    import dataclasses
    import gc
    import statistics

    import numpy as np

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel
    from tpu_cc_manager_torch.parallel.train import (
        cross_entropy,
        make_llama_train_state,
        make_llama_train_step,
    )

    cfg = LlamaConfig.llama3_2_1b()  # f32 parameters, bf16 compute
    if not cfg.resolved_use_flash("cuda") or cfg.remat:
        fail("the 1B training config must run flash attention without remat")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    ).to("cuda")
    torch.cuda.reset_peak_memory_stats()

    def run(steps: int):
        """``steps`` steps from a fresh state (seed 0): losses, seconds,
        the state and the step function."""
        state, shardings = make_llama_train_state(cfg, mesh, seed=0)
        step = make_llama_train_step(cfg, mesh, shardings)
        losses, seconds = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, loss = step(state, tokens)
            losses.append(float(loss))  # waits for the step
            seconds.append(time.perf_counter() - t0)
        return losses, seconds, state, step

    ops.reset_launch_counts()
    losses, seconds, state, step = run(TRAIN_STEPS)
    launches = {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile_step(torch, "train", lambda: float(step(state, tokens)[1]), LLAMA_KERNEL_GROUPS)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # Determinism: no atomics anywhere on the path, so the first steps on a
    # fresh state repeat every printed digit.
    printed = [round(x, 6) for x in losses[:DETERMINISM_STEPS]]
    again, _, state, step = run(DETERMINISM_STEPS)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    again = [round(x, 6) for x in again]
    say(f"train determinism: steps 1-{DETERMINISM_STEPS} losses {printed}, on fresh state "
        f"again {again}: {'identical' if again == printed else 'DIFFERENT'}")
    if again != printed:
        fail(f"1B training losses differ between two runs: {printed} vs {again}")

    ms = 1e3 * statistics.median(seconds[1:])  # the first step pays for lazy init
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    L, H, D, S = cfg.n_layers, cfg.n_heads, cfg.head_dim, TRAIN_SEQ
    # Model FLOPs: 6 per token per matmul weight (the embedding is a gather,
    # the norm scales no matmul), plus causal attention's QK^T and PV, 3x for
    # forward and backward.
    mm_params = cfg.param_count() - cfg.vocab_size * cfg.dim - (2 * L + 1) * cfg.dim
    flops = 6.0 * mm_params * n_tok + 3 * L * 2 * 2.0 * TRAIN_BATCH * H * D * S * (S + 1) / 2
    mfu = flops / (ms / 1e3) / peaks["bf16"]
    say(f"train Llama-3.2-1B (params {cfg.param_count()}, f32 master weights, bf16 compute, "
        f"flash, batch {TRAIN_BATCH}x{TRAIN_SEQ}, AdamW lr 3e-4 wd 0.01): losses "
        f"{[round(x, 6) for x in losses]}")
    say(f"train: first loss {losses[0]:.6f} (one-device step: {FIRST_LOSS:.6f}); step_ms "
        f"median(steps 2-{TRAIN_STEPS}) on the FSDP2 mesh={ms:.2f} (one-device step: "
        f"{ONE_DEVICE_STEP_MS} on an H100 80GB HBM3 at 700 W) first={1e3 * seconds[0]:.2f} "
        f"tokens_per_sec={n_tok / (ms / 1e3):.1f} mfu={mfu:.4f} (flops/step {flops:.4e} = "
        f"6*{mm_params}*{n_tok} + attention 3*{L}*2*2*B*H*D*S(S+1)/2; bf16 peak) "
        f"max_memory_allocated_gb={peak_gb:.2f} launches={launches}")
    if not all(np.isfinite(losses)) or any(b >= a for a, b in zip(losses, losses[1:])):
        fail(f"1B training loss is not finite and strictly decreasing: {losses}")
    n = L * TRAIN_STEPS
    want = {"K1": 0, "K2": n, "K3": n, "K4": n, "K1/sm90": 0, "K1/simt": 0,
            "K2/sm90": n, "K2/simt": 0, "K3/sm90": n, "K3/simt": 0, "K4/sm90": n, "K4/simt": 0}
    if launches != want:
        fail(f"1B training launched {launches}, want {want} ({L} per step each of K2/K3/K4, "
             f"all on their sm90 kernels)")

    def grads(use_flash: bool) -> dict:
        model = LlamaModel(dataclasses.replace(cfg, use_flash=use_flash), device="cuda", seed=0)
        logits, _ = model(tokens[:, :-1])
        loss = cross_entropy(logits, tokens[:, 1:])
        del logits
        loss.backward()
        out = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
        gc.collect()
        torch.cuda.empty_cache()
        return out

    flash = grads(True)
    einsum = grads(False)
    rel = grad_rel_err(flash, einsum, list(einsum))
    per = {n: grad_rel_err(flash, einsum, [f"blocks.attn.{n}"]) for n in ("wq", "wk", "wv", "wo")}
    say(f"train: flash (K2/K3/K4) vs einsum gradient on the same weights: whole rel_err="
        f"{rel:.4e} (limit {TRAIN_GRAD_LIMIT:g}); "
        + " ".join(f"{n}={e:.4e}" for n, e in per.items()))
    del flash, einsum
    torch.cuda.empty_cache()
    if not rel < TRAIN_GRAD_LIMIT:
        fail(f"1B flash-path gradient differs from the einsum path by {rel:.4e}")
    return {"launches": launches, "losses": losses, "step_ms": ms, "grad_rel_err": rel}


def resnet_smoke(torch) -> None:
    """The ResNet-50 smoke through the agent's runner, then one more step
    of the same state in this process under torch.profiler."""
    from tpu_cc_manager_torch.parallel.mesh import make_mesh
    from tpu_cc_manager_torch.smoke import resnet_train
    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

    t0 = time.perf_counter()
    try:
        res = run_workload_subprocess("resnet", timeout_s=600, extra_args=[
            "--size", "resnet50", "--batch", str(RESNET_BATCH * torch.cuda.device_count())])
    except SmokeError as e:
        fail(f"resnet smoke: {e}")
    wall_s = time.perf_counter() - t0
    say(f"resnet smoke: child wall_s={wall_s:.2f} " + json.dumps({k: res.get(k) for k in (
        "model", "backend", "device_name", "devices", "batch", "timing_valid",
        "images_per_sec", "seconds_per_step", "mfu", "flops_per_step", "loss_first",
        "loss_last")}))
    say(f"resnet smoke: per_device={json.dumps(res['per_device'])}")
    check_devices("resnet smoke", res, torch.cuda.device_count())
    if not (res["ok"] and res["backend"] == "cuda" and res["timing_valid"]
            and res["loss_last"] < res["loss_first"]):
        fail(f"resnet smoke failed its oracle or ran off the card: {res}")

    mesh = make_mesh(resnet_train.MESH_SPEC)
    state = resnet_train.make_resnet_train_state("resnet50", mesh, seed=0)
    step = resnet_train.make_resnet_train_step(mesh)
    images, labels = resnet_batch(torch)
    for _ in range(3):  # warm: cuDNN's algorithm choice, the allocator
        step(state, images, labels)
    profile_step(torch, "resnet", lambda: float(step(state, images, labels)[1]),
                 RESNET_KERNEL_GROUPS)


def resnet_batch(torch):
    """The smoke's batch: 64 images of 224² and their labels from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((RESNET_BATCH, 224, 224, 3), generator=gen, device="cuda")
    return images, torch.randint(0, 1000, (RESNET_BATCH,), generator=gen, device="cuda")


def checkpoint_round_trip(torch) -> None:
    """Train, save, train on; restore into a fresh state from another seed
    and train on: the two continuations must agree bit for bit."""
    import pathlib
    import shutil

    from tpu_cc_manager_torch.parallel.checkpoint import TrainCheckpointer
    from tpu_cc_manager_torch.parallel.mesh import make_mesh
    from tpu_cc_manager_torch.smoke import resnet_train

    directory = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(directory, ignore_errors=True)
    # cuDNN's weight-gradient algorithms may otherwise use atomics.
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        mesh = make_mesh(resnet_train.MESH_SPEC)
        step = resnet_train.make_resnet_train_step(mesh)
        images, labels = resnet_batch(torch)
        state = resnet_train.make_resnet_train_state("resnet50", mesh, seed=0)
        for _ in range(CHECKPOINT_STEPS):
            step(state, images, labels)

        def snapshot(s) -> dict:
            out = {f"param {n}": p.detach().clone() for n, p in s.model.named_parameters()}
            out.update({f"buffer {n}": b.clone() for n, b in s.model.named_buffers()})
            out.update({f"momentum {n}": s.optimizer.state[p]["momentum_buffer"].clone()
                        for n, p in s.model.named_parameters()})
            return out

        ckpt = TrainCheckpointer(str(directory))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(state.step, state)
        save_s = time.perf_counter() - t0
        saved, saved_step = snapshot(state), state.step
        nbytes = sum(f.stat().st_size for f in (directory / str(saved_step)).rglob("*")
                     if f.is_file())
        losses_a = [float(step(state, images, labels)[1]) for _ in range(CHECKPOINT_STEPS)]
        del state

        fresh = resnet_train.make_resnet_train_state("resnet50", mesh, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored, restored_step = snapshot(fresh), fresh.step
        differ = [k for k in saved if not torch.equal(saved[k], restored[k])]
        losses_b = [float(step(fresh, images, labels)[1]) for _ in range(CHECKPOINT_STEPS)]
        ckpt.close()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        shutil.rmtree(directory, ignore_errors=True)
    say(f"checkpoint (ResNet-50 state after {saved_step} steps): {nbytes} bytes written, "
        f"save_s={save_s:.3f} restore_s={restore_s:.3f}; restored step {restored_step}, "
        f"{len(saved) - len(differ)}/{len(saved)} tensors equal; losses after the save "
        f"{losses_a}, after the restore {losses_b}: "
        f"{'bit-equal' if losses_a == losses_b else 'DIFFERENT'}")
    if differ or restored_step != saved_step or losses_a != losses_b:
        fail(f"checkpoint round trip: tensors differ {differ[:5]}, step {restored_step} vs "
             f"{saved_step}, losses {losses_a} vs {losses_b}")


class ThreadRing:
    """Virtual rank ``index`` of ``size`` threads on one card, in place of
    ``GroupRing``'s process group: ``shift`` posts this rank's tensors with
    an event on its stream, meets the others at the barrier, copies the
    previous rank's on its own stream once their event has passed, and
    meets them again, so no rank posts the next hop before every rank has
    taken this one."""

    def __init__(self, index: int, size: int, board: list, barrier):
        self.index, self.size, self.board, self.barrier = index, size, board, barrier

    def shift(self, tensors):
        import torch

        stream = torch.cuda.current_stream()
        posted = torch.cuda.Event()
        posted.record(stream)
        self.board[self.index] = (list(tensors), posted)
        self.barrier.wait()
        sent, sent_event = self.board[(self.index - 1) % self.size]
        stream.wait_event(sent_event)
        received = [t.clone() for t in sent]
        for t in sent:
            t.record_stream(stream)  # the sender may free it once we are past
        self.barrier.wait()
        return received


def run_ring(torch, q, k, v, g, streams):
    """The ring's forward and backward on one thread per stream, one virtual
    rank each holding its chunk of the sequence: the joined (out, dq, dk,
    dv), and each rank's forward and backward ms from CUDA events on its
    stream."""
    import threading

    from tpu_cc_manager_torch.ops.ring_attention import ring_backward, ring_forward

    n = len(streams)
    c = q.shape[2] // n
    chunks = [[t[:, :, i * c : (i + 1) * c].contiguous() for t in (q, k, v, g)]
              for i in range(n)]
    board = [None] * n
    barrier = threading.Barrier(n, timeout=RING_BARRIER_TIMEOUT_S)
    results, errors = [None] * n, [None] * n

    def rank(i: int) -> None:
        try:
            with torch.cuda.stream(streams[i]):
                ring = ThreadRing(i, n, board, barrier)
                qi, ki, vi, gi = chunks[i]
                events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                events[0].record()
                out, lse = ring_forward(qi, ki, vi, ring)
                events[1].record()
                grads = ring_backward(qi, ki, vi, out, lse, gi, ring)
                events[2].record()
                results[i] = (out, *grads, events)
        except BaseException as e:  # a failed rank must not leave the others waiting
            errors[i] = e
            barrier.abort()

    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if any(e is not None for e in errors):
        # The first rank to fail broke the barrier for the others.
        fail(f"ring n={n}: ranks failed: {[repr(e) for e in errors]}")
    joined = [torch.cat([r[j] for r in results], dim=2) for j in range(4)]
    fwd_ms = [r[4][0].elapsed_time(r[4][1]) for r in results]
    bwd_ms = [r[4][1].elapsed_time(r[4][2]) for r in results]
    return joined, fwd_ms, bwd_ms


def check_ring(torch) -> None:
    """Phase 10: ring attention's per-rank code on this card (see the module
    docstring); the launch counts must stay 0 while it runs."""
    import gc

    import torch.nn.functional as F

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    for B, H, S, D in RING_SHAPES:
        G = H // RING_KV_HEADS
        q, g = (torch.randn((B, H, S, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        k, v = (torch.randn((B, RING_KV_HEADS, S, D), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        # The plain reference on the whole sequence, K/V repeated, in f32 on
        # the same bf16 values; its autograd gradient.
        leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
        ref = fa.reference_attention(leaves[0], *(t.repeat_interleave(G, dim=1)
                                                  for t in leaves[1:]))
        wants = [ref.detach(), *torch.autograd.grad(ref, leaves, g.float())]
        del ref, leaves
        gc.collect()
        torch.cuda.empty_cache()
        for n in RING_SIZES:
            streams = [torch.cuda.Stream() for _ in range(n)]
            ops.reset_launch_counts()
            run_ring(torch, q, k, v, g, streams)  # warm: the allocator, cuBLAS
            got, fwd_ms, bwd_ms = run_ring(torch, q, k, v, g, streams)
            # The ring's own work: every rank's kernels, forward and backward.
            busy = device_ms(lambda: run_ring(torch, q, k, v, g, streams), iters=2, warmup=0)
            launches = {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}
            tols = (K2_TOL["bfloat16"],) + (K34_TOL["bfloat16"],) * 3
            rels = [float((a.float() - w).abs().max()) / float(w.abs().max())
                    for a, w in zip(got, wants)]
            ok = (all(r <= tol for r, tol in zip(rels, tols))
                  and all(bool(torch.isfinite(a).all()) for a in got)
                  and not any(launches.values()))
            say(f"ring n={n} (B={B} H={H} KV={RING_KV_HEADS} S={S} D={D} bf16, causal): "
                f"out rel_err={rels[0]:.3e} (tol {tols[0]:g}) dq={rels[1]:.3e} dk={rels[2]:.3e} "
                f"dv={rels[3]:.3e} (tol {tols[1]:g}); per-rank ms, threads on one card: "
                f"forward {[round(x, 4) for x in fwd_ms]} backward "
                f"{[round(x, 4) for x in bwd_ms]}; device_ms of one forward and backward, "
                f"all ranks={fmt_ms(busy)}; K1-K4 launches {launches} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"ring attention n={n} at {(B, H, S, D)} disagrees with the reference, "
                     f"or launched a kernel: {rels} {launches}")
            del got
            torch.cuda.empty_cache()
        del wants
        gc.collect()
        torch.cuda.empty_cache()

        # The whole sequence on one card, K/V repeated: K2 + K3 + K4, and SDPA.
        kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
        out, lse = fa.flash_forward(q, kr, vr, True)
        delta = fa.attention_delta(out, g)
        args = (q, kr, vr, g, lse, delta, True)
        k2 = time_ms(lambda: fa.flash_forward(q, kr, vr, True))
        k3 = time_ms(lambda: fa.flash_backward_dq(*args))
        k4 = time_ms(lambda: fa.flash_backward_dkv(*args))
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True))
        sdpa_leaves = [t.detach().requires_grad_(True) for t in (q, kr, vr)]

        def sdpa_step():
            o = F.scaled_dot_product_attention(*sdpa_leaves, is_causal=True)
            return torch.autograd.grad(o, sdpa_leaves, g)

        sdpa_both = time_ms(sdpa_step, iters=10)
        say(f"ring comparison, whole sequence on one card (B={B} H={H} S={S} D={D}, K/V "
            f"repeated): K2 {k2:.4f} + K3 {k3:.4f} + K4 {k4:.4f} = {k2 + k3 + k4:.4f} ms; "
            f"SDPA forward {sdpa_fwd:.4f} ms, forward and backward {sdpa_both:.4f} ms")
        del q, k, v, g, kr, vr, out, lse, delta, args, sdpa_leaves
        gc.collect()
        torch.cuda.empty_cache()
    free_thread_workspaces(torch)


class ThreadTP:
    """Virtual tp rank ``index`` of ``size`` threads on one card, in place of
    ``GroupTP``'s process group: each exchange posts this rank's tensor with
    an event on its stream, meets the others at the barrier, reads every
    rank's tensor on its own stream once their events have passed (summing
    or joining in rank order, so every rank gets the same bits), and meets
    them again, so no rank posts the next exchange before every rank has
    taken this one."""

    def __init__(self, index: int, size: int, board: list, barrier):
        self.index, self.size, self.board, self.barrier = index, size, board, barrier

    def _exchange(self, t, combine):
        import torch

        stream = torch.cuda.current_stream()
        posted = torch.cuda.Event()
        posted.record(stream)
        self.board[self.index] = (t, posted)
        self.barrier.wait()
        parts = []
        for sent, event in list(self.board):
            stream.wait_event(event)
            sent.record_stream(stream)  # the sender may free it once we are past
            parts.append(sent)
        out = combine(parts)
        self.barrier.wait()
        return out

    def all_reduce(self, t):
        def total(parts):
            out = parts[0].clone()
            for part in parts[1:]:
                out += part
            return out

        return self._exchange(t, total)

    def all_gather(self, t, dim: int):
        import torch

        return self._exchange(t, lambda parts: torch.cat(parts, dim=dim))


def run_tp(torch, models, tokens, streams):
    """One forward of every tp rank's model on its own thread and stream:
    each rank's logits and forward ms (CUDA events on its stream, waits
    included)."""
    import threading

    n = len(models)
    barrier = models[0].tp.barrier
    results, errors = [None] * n, [None] * n

    def rank(i: int) -> None:
        try:
            with torch.cuda.stream(streams[i]), torch.inference_mode():
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                logits, _ = models[i](tokens)
                end.record()
                results[i] = (logits, start, end)
        except BaseException as e:  # a failed rank must not leave the others waiting
            errors[i] = e
            barrier.abort()

    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if any(e is not None for e in errors):
        fail(f"tp={n}: ranks failed: {[repr(e) for e in errors]}")
    return [r[0] for r in results], [r[1].elapsed_time(r[2]) for r in results]


def check_tp(torch, k2_timed) -> dict:
    """Phase 11: the tp Llama's per-rank forward on this card (see the
    module docstring). Returns the launch counts of each forward checked,
    by path."""
    import gc
    import threading

    import numpy as np

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models.convert import shard_state_dict
    from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel
    from tpu_cc_manager_torch.smoke.llama_infer import argmax_shortfall

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    if not cfg.resolved_use_flash("cuda"):
        fail("the 8B tp forward must run flash attention")
    L = cfg.n_layers
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (TP_BATCH, TP_SEQ))).to("cuda")
    one = LlamaModel(cfg, device="cuda", seed=0)

    def forward_one():
        with torch.inference_mode():
            return one(tokens)[0]

    def counts() -> dict:
        return {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}

    def want(n: int) -> dict:
        return k2_launches(L * n)

    paths = {}
    ops.reset_launch_counts()
    ref = forward_one()
    torch.cuda.synchronize()
    paths["tp=1 forward"] = counts()
    if paths["tp=1 forward"] != want(1):
        fail(f"the 8B tp=1 forward launched {paths['tp=1 forward']}, want {want(1)}")
    one_ms = time_ms(forward_one, iters=3, warmup=1)
    one_dev = device_ms(forward_one, iters=2, warmup=0)
    scale = float(ref.abs().max())
    state = one.state_dict()
    say(f"tp=1 Llama-3-8B forward (bf16 weights, flash, batch {TP_BATCH}x{TP_SEQ}): logits "
        f"{tuple(ref.shape)} max|ref|={scale:.4f} forward_ms={one_ms:.2f} device_ms="
        f"{fmt_ms(one_dev)} launches={paths['tp=1 forward']}")

    k2_by_shape = {tuple(t["shape"]): t for t in k2_timed}
    for n in TP_SIZES:
        board, barrier = [None] * n, threading.Barrier(n, timeout=TP_BARRIER_TIMEOUT_S)
        models = []
        for i in range(n):
            model = LlamaModel(cfg, device="cuda", seed=None, tp=ThreadTP(i, n, board, barrier))
            model.load_state_dict(shard_state_dict(state, cfg, i, n), strict=True)
            if model.blocks.attn.n_heads != cfg.n_heads // n:
                fail(f"tp={n} rank {i} holds {model.blocks.attn.n_heads} heads")
            models.append(model)
        streams = [torch.cuda.Stream() for _ in range(n)]
        ops.reset_launch_counts()
        logits, _ = run_tp(torch, models, tokens, streams)
        launches = counts()
        paths[f"tp={n} forward, virtual ranks"] = launches
        same = all(torch.equal(x, logits[0]) for x in logits[1:])
        rel = float((logits[0] - ref).abs().max()) / scale
        margin = argmax_shortfall(ref[:, -1], logits[0][:, -1].argmax(dim=-1))
        del logits
        fwd_ms = run_tp(torch, models, tokens, streams)[1]
        busy = device_ms(lambda: run_tp(torch, models, tokens, streams), iters=2, warmup=0)
        k2 = k2_by_shape[(TP_BATCH, cfg.n_heads // n, TP_SEQ, cfg.head_dim)]
        ok = (same and rel <= TP_LOGIT_LIMIT and margin <= TRANSCRIPT_LIMIT
              and launches == want(n))
        say(f"tp={n} Llama-3-8B forward on {n} virtual ranks: logits rel_err={rel:.4e} (limit "
            f"{TP_LOGIT_LIMIT:g}) ranks_identical={same} last-position argmax margin="
            f"{margin:.6f} (limit {TRANSCRIPT_LIMIT:g}); per-rank forward_ms "
            f"{[round(x, 2) for x in fwd_ms]}; device_ms of one forward, all ranks="
            f"{fmt_ms(busy)} (tp=1: {fmt_ms(one_dev)}); K2 [{k2['variant']}] at "
            f"{tuple(k2['shape'])} kernel_ms={k2['ms']:.4f} sdpa_ms={k2['library_ms']:.4f}; "
            f"launches {launches} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"tp={n}: joined logits rel_err {rel:.4e}, margin {margin:.6f}, ranks "
                 f"identical {same}, launches {launches} (want {want(n)})")
        del models, board
        gc.collect()
        torch.cuda.empty_cache()
    del one, state, ref
    free_thread_workspaces(torch)
    return paths


def gloo_tp_rank(fault: bool) -> int:
    """One of the processes of :func:`check_gloo_tp_step` (rank and world
    in torchrun's environment names): three Llama-3.2-1B train steps at
    ``{tp: 2}`` on this card over a gloo group (NCCL refuses two ranks of
    one communicator on one GPU; gloo stages the CUDA tensors through the
    host), with ``GLOO_TP_FAULT`` planted if ``fault``. Prints one JSON
    line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models import llama
    from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh
    from tpu_cc_manager_torch.parallel.train import make_llama_train_state, make_llama_train_step

    if fault:
        llama.copy_to_tp = lambda x, tp: x
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    mesh = make_mesh(MeshSpec(dp=1, tp=GLOO_TP), device_type="cuda")
    cfg = llama.LlamaConfig.llama3_2_1b()
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    ).to("cuda")
    state, shardings = make_llama_train_state(cfg, mesh, seed=0)
    step = make_llama_train_step(cfg, mesh, shardings)
    ops.reset_launch_counts()
    losses, seconds = [], []
    for _ in range(GLOO_TP_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    print(json.dumps({"rank": dist.get_rank(), "losses": losses, "seconds": seconds,
                      "launches": {**ops.launch_counts(),
                                   **flat_variants(ops.variant_launch_counts())},
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)
    dist.destroy_process_group()
    return 0


def run_gloo_tp(fault: bool, one_rank_losses) -> tuple[list[dict], list[float]]:
    """The ``GLOO_TP`` processes of one phase-12 run: each rank's JSON line
    and the losses' relative gaps to the one-rank step's. Fails if a rank
    fails or hangs."""
    from tpu_cc_manager_torch.utils.launch import run_ranks

    cmd = [sys.executable, __file__, "--gloo-tp-child", GLOO_TP_FAULT if fault else "sound"]
    try:
        # Both ranks' steps peak at about 25 GB each on the one card:
        # expandable segments keep their caches from fragmenting past it.
        outs = run_ranks(cmd, GLOO_TP, GLOO_TP_TIMEOUT_S,
                         env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    except (RuntimeError, TimeoutError) as e:
        fail(f"gloo tp={GLOO_TP}{' with ' + GLOO_TP_FAULT if fault else ''}: {e}")
    results = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    want = one_rank_losses[:GLOO_TP_STEPS]
    return results, [abs(a - b) / abs(b) for a, b in zip(results[0]["losses"], want)]


def check_gloo_tp_step(torch, one_rank_losses) -> dict:
    """Phase 12: two processes on this one card train Llama-3.2-1B at
    ``{tp: 2}`` over gloo; their losses must agree and match the one-rank
    step's (phase 7) within ``GLOO_TP_LOSS_TOL``; the same run with
    ``GLOO_TP_FAULT`` planted must not. Returns the launch counts of the
    sound run's ranks together."""
    # The ranks share the card with this process: hand back its cache first.
    report_memory(torch, f"gloo tp={GLOO_TP}")
    results, rels = run_gloo_tp(False, one_rank_losses)
    losses = results[0]["losses"]
    want = one_rank_losses[:GLOO_TP_STEPS]
    n = 16 * GLOO_TP_STEPS  # one K2, K3 and K4 per layer and step
    per_rank = {"K1": 0, "K2": n, "K3": n, "K4": n, "K1/sm90": 0, "K1/simt": 0, "K2/sm90": n,
                "K2/simt": 0, "K3/sm90": n, "K3/simt": 0, "K4/sm90": n, "K4/simt": 0}
    same = all(r["losses"] == losses for r in results[1:])
    ok = same and max(rels) <= GLOO_TP_LOSS_TOL and all(r["launches"] == per_rank
                                                        for r in results)
    say(f"gloo tp={GLOO_TP}, {GLOO_TP} processes on one card, Llama-3.2-1B train step: losses "
        f"{[round(x, 6) for x in losses]} (other ranks {'identical' if same else 'DIFFERENT'}; "
        f"one-rank {[round(x, 6) for x in want]}, rel {[f'{x:.2e}' for x in rels]}, limit "
        f"{GLOO_TP_LOSS_TOL:g}); step seconds "
        f"{[[round(x, 3) for x in r['seconds']] for r in results]}; max_memory_allocated_gb "
        f"{[round(r['max_memory_allocated_gb'], 2) for r in results]}; launches per rank "
        f"{[r['launches'] for r in results]} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"the {GLOO_TP}-process tp={GLOO_TP} train step over gloo disagrees with the "
             f"one-rank step, or launched other than {per_rank} per rank")

    faulty, fault_rels = run_gloo_tp(True, one_rank_losses)
    caught = max(fault_rels) > GLOO_TP_LOSS_TOL
    say(f"gloo tp={GLOO_TP} with {GLOO_TP_FAULT} planted: losses "
        f"{[round(x, 6) for x in faulty[0]['losses']]} rel {[f'{x:.2e}' for x in fault_rels]} "
        f"(limit {GLOO_TP_LOSS_TOL:g}; sound run {max(rels):.2e}): "
        f"{'caught' if caught else 'MISSED'}")
    if not caught:
        fail(f"the gloo tp={GLOO_TP} loss limit {GLOO_TP_LOSS_TOL:g} misses {GLOO_TP_FAULT}")
    return {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}


def report_memory(torch, label: str) -> None:
    """What this process still holds on the card, printed before a phase
    that starts other processes on it (after emptying its cache)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"{label}: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free on the card")


def gloo_smoke_rank() -> int:
    """One of the processes of :func:`check_gloo_smoke` (rank and world in
    torchrun's environment names): the Llama smoke's per-rank function at
    ``tp=GLOO_TP`` on this card over a gloo group, clean and then with the
    cache off-by-one. Prints one JSON line: both results."""
    import gc

    import torch
    import torch.distributed as dist

    from tpu_cc_manager_torch.smoke.llama_infer import verify_replica

    size = cut_smoke_size()
    torch.cuda.set_device(0)
    # gloo first: the smoke's own bootstrap would ask for NCCL, which refuses
    # two ranks of one communicator on one GPU.
    dist.init_process_group("gloo")
    runs = []
    for offset in (0, 1):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = verify_replica(torch.device("cuda", 0), dist.get_rank(), dist.get_world_size(),
                                size=size, batch=SMOKE_BATCH,
                                prompt_len=SMOKE_PROMPT,
                                decode_len=SMOKE_DECODE, seed=0, cache_position_offset=offset,
                                tp=GLOO_TP)
        result.update(wall_s=time.perf_counter() - t0,
                      max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs.append(result)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(runs), flush=True)
    dist.destroy_process_group()
    return 0


def check_gloo_smoke(torch, one_card: dict) -> dict:
    """Phase 13: the Llama-3-8B smoke as one tp group of ``GLOO_TP``
    processes on this card over gloo (see the module docstring). Returns the
    clean run's launches of both ranks together."""
    from tpu_cc_manager_torch.smoke.llama_infer import combine_ranks
    from tpu_cc_manager_torch.utils.launch import run_ranks

    report_memory(torch, f"llama smoke tp={GLOO_TP}")
    t0 = time.perf_counter()
    try:
        outs = run_ranks([sys.executable, __file__, "--gloo-smoke-child"], GLOO_TP,
                         GLOO_SMOKE_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"llama smoke tp={GLOO_TP} over gloo: {e}")
    wall_s = time.perf_counter() - t0
    ranks = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    clean = combine_ranks([r[0] for r in ranks], GLOO_TP)
    faulty = combine_ranks([r[1] for r in ranks], GLOO_TP)
    per_rank = [{**r[0]["kernel_launches"], **flat_variants(r[0]["kernel_launches_by_variant"])}
                for r in ranks]
    want = k2_launches(SMOKE_CUT_LAYERS)  # one flash forward
    rel = clean["flash_kernel_rel_err"]
    # ok: every rank's three oracles (flash within 5e-2) and the ranks agreeing.
    ok = clean["ok"] and rel is not None and all(c == want for c in per_rank)
    say(f"llama smoke tp={GLOO_TP}, {GLOO_TP} processes on one card over gloo ({cut_smoke_size()}, "
        f"batch {SMOKE_BATCH}, prompt {SMOKE_PROMPT}, decode {SMOKE_DECODE}): ok={clean['ok']} "
        f"oracle_ok={clean['oracle_ok']} transcript_ok={clean['transcript_ok']} "
        f"disagreeing_devices={clean['disagreeing_devices']} "
        f"transcript_margin={clean['transcript_margin']} "
        f"(limit {TRANSCRIPT_LIMIT:g}; phase 6 on one card: {one_card['transcript_margin']}) "
        f"flash_kernel_rel_err={rel} (phase 6: {one_card['flash_kernel_rel_err']}); "
        f"ms_per_token={clean['ms_per_token']} over gloo host staging, not NCCL (phase 6 on one "
        f"card: {one_card['ms_per_token']}); prefill_tokens_per_sec="
        f"{clean['prefill_tokens_per_sec']}; per rank: wall_s "
        f"{[[round(run['wall_s'], 2) for run in r] for r in ranks]} max_memory_allocated_gb "
        f"{[[round(run['max_memory_allocated_gb'], 2) for run in r] for r in ranks]}; launches "
        f"per rank {per_rank}; both runs {wall_s:.2f}s {'ok' if ok else 'MISMATCH'}")
    say(f"llama smoke tp={GLOO_TP} per_device={json.dumps(clean['per_device'])}")
    if not ok:
        fail(f"the tp={GLOO_TP} Llama smoke over gloo failed its oracles, its ranks disagree, "
             f"or a rank launched other than {want}: {clean}")
    caught = not faulty["ok"] and not faulty["transcript_ok"]
    say(f"llama smoke tp={GLOO_TP} with cache_position_offset=1: ok={faulty['ok']} "
        f"transcript_ok={faulty['transcript_ok']} transcript_margin="
        f"{faulty['transcript_margin']} (limit {TRANSCRIPT_LIMIT:g}; clean run "
        f"{clean['transcript_margin']}) disagreeing_devices={faulty['disagreeing_devices']}: "
        f"{'caught' if caught else 'MISSED'}")
    if not caught:
        fail(f"the tp={GLOO_TP} transcript oracle missed the cache off-by-one")
    return {k: sum(c[k] for c in per_rank) for k in per_rank[0]}


def hf_state_dict(torch, hf) -> dict:
    """An HF ``LlamaForCausalLM`` state dict of ``hf``'s geometry, as a
    tied checkpoint loads it: bf16 host tensors, projections ``(out, in)``,
    no ``lm_head.weight``; projections normal(0, 1/sqrt(in)), the embedding
    normal(0, 0.02), norm scales normal(1, 0.1), from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(8)

    def draw(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, device="cuda").mul_(std).add_(mean)
        return t.to(torch.bfloat16).cpu()

    dim, inter = hf.hidden_size, hf.intermediate_size
    kv = hf.num_key_value_heads * dim // hf.num_attention_heads
    shapes = {"self_attn.q_proj": (dim, dim), "self_attn.k_proj": (kv, dim),
              "self_attn.v_proj": (kv, dim), "self_attn.o_proj": (dim, dim),
              "mlp.gate_proj": (inter, dim), "mlp.up_proj": (inter, dim),
              "mlp.down_proj": (dim, inter)}
    sd = {"model.embed_tokens.weight": draw((hf.vocab_size, dim), 0.02)}
    for i in range(hf.num_hidden_layers):
        for name, shape in shapes.items():
            sd[f"model.layers.{i}.{name}.weight"] = draw(shape, shape[1] ** -0.5)
        for name in ("input_layernorm", "post_attention_layernorm"):
            sd[f"model.layers.{i}.{name}.weight"] = draw((dim,), 0.1, 1.0)
    sd["model.norm.weight"] = draw((dim,), 0.1, 1.0)
    return sd


def jax_layout(sd: dict, layers: int) -> dict:
    """The JAX package's ``variables`` for the same weights, numpy f32:
    this script's own transpose of each ``(out, in)`` projection and its
    own stacking (what ``params_from_jax`` is then given)."""
    import numpy as np

    def arr(key):
        return sd[key].float().numpy()

    def stack(name, transpose=True):
        return np.stack([arr(f"model.layers.{i}.{name}.weight").T if transpose
                         else arr(f"model.layers.{i}.{name}.weight") for i in range(layers)])

    embed = arr("model.embed_tokens.weight")
    return {"params": {
        "embedding": embed, "lm_head": np.ascontiguousarray(embed.T),
        "final_norm": {"scale": arr("model.norm.weight")},
        "blocks": {
            "attn": {n: {"kernel": stack(f"self_attn.{h}")} for n, h in
                     (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj"))},
            "attn_norm": {"scale": stack("input_layernorm", False)},
            "mlp_norm": {"scale": stack("post_attention_layernorm", False)},
            "mlp": {n: {"kernel": stack(f"mlp.{h}")} for n, h in
                    (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj"))},
        }}}


def host_rss() -> int:
    """This process's resident set (``VmRSS``), in bytes."""
    with open("/proc/self/status", encoding="ascii") as f:
        line = next(line for line in f if line.startswith("VmRSS:"))
    return int(line.split()[1]) * 1024


def peak_rss_during(fn):
    """``fn()``'s result and the largest resident set sampled every
    millisecond while it ran (the card's machine has no ``VmHWM`` to
    reset)."""
    import threading

    peak = [host_rss()]
    done = threading.Event()

    def sample():
        while not done.wait(1e-3):
            peak[0] = max(peak[0], host_rss())

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        result = fn()
    finally:
        done.set()
        sampler.join()
    return result, max(peak[0], host_rss())


def check_hf_loader(torch) -> dict:
    """Phase 14: the Hugging Face loader at Llama-3.2-1B width (see the
    module docstring). Returns the launches of the converted model's
    forward."""
    import gc
    import types

    import numpy as np

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models.convert import (
        config_from_hf,
        hf_state_dict_to_params,
        params_from_jax,
    )
    from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel

    hf = types.SimpleNamespace(**HF_1B_CONFIG)
    cfg = config_from_hf(hf, param_dtype=torch.bfloat16)
    if cfg != LlamaConfig.llama3_2_1b(param_dtype=torch.bfloat16):
        fail(f"config_from_hf of the published Llama-3.2-1B config gave {cfg}")
    sd = hf_state_dict(torch, hf)
    hf_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    rss = host_rss()

    def convert():
        t0 = time.perf_counter()
        out = hf_state_dict_to_params(sd, cfg, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (state, convert_s), peak = peak_rss_during(convert)
    growth = peak - rss
    say(f"hf loader (Llama-3.2-1B, {cfg.param_count()} params, tied, llama3 rope scaling): "
        f"{hf_bytes / 1e9:.2f} GB of bf16 HF tensors converted onto the card in "
        f"{convert_s:.3f}s; host RSS {rss / 1e9:.2f} GB before, peak {peak / 1e9:.2f} GB "
        f"during (sampled every ms): +{growth / 1e9:.3f} GB, where an f32 copy of the model "
        f"would add {2 * hf_bytes / 1e9:.2f} GB")
    if growth >= 2 * hf_bytes:
        fail(f"hf_state_dict_to_params grew the host RSS by {growth / 1e9:.2f} GB: an f32 copy")

    ref = params_from_jax(jax_layout(sd, cfg.n_layers), cfg, device="cuda")
    del sd
    differ = [k for k in ref if not torch.equal(state[k], ref[k])]
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (HF_BATCH, HF_SEQ))).to("cuda")
    model = LlamaModel(cfg, device="cuda", seed=None)

    def forward(weights):
        model.load_state_dict(weights, strict=True)
        with torch.inference_mode():
            return model(tokens)[0]

    ops.reset_launch_counts()
    got = forward(state)
    torch.cuda.synchronize()
    launches = {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}
    want = forward(ref)
    same = torch.equal(got, want)
    finite = bool(torch.isfinite(got).all())
    ok = not differ and same and finite and launches == k2_launches(cfg.n_layers)
    say(f"hf loader: {len(ref) - len(differ)}/{len(ref)} tensors equal to params_from_jax of "
        f"this script's numpy transpose; flash forward {HF_BATCH}x{HF_SEQ}: logits "
        f"{tuple(got.shape)} finite={finite} bit-equal={same} (max abs diff "
        f"{float((got - want).abs().max()):.3e}); launches {launches} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"the HF loader's weights or logits differ from the params_from_jax route: "
             f"tensors {differ}, logits equal {same}, launches {launches}")
    del state, ref, model, got, want, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class FlipNvml:
    """NVML for phase 15's stand-in flip: the real library for names,
    handles and the attestation calls, with the system CC state taken from
    the stand-in admin library's committed modes (the card itself is never
    flipped). A BDF the real NVML cannot look up (a sandboxed kernel gives
    it no PCI information) is joined to its handle through torch's BDF and
    the card's UUID."""

    def __init__(self, admin_dir: str, uuid_by_bdf: dict) -> None:
        from tpu_cc_manager_torch.gpudev.nvml import Nvml

        self.real = Nvml()
        self.admin_dir = admin_dir
        self.uuid_by_bdf = uuid_by_bdf

    def __enter__(self):
        self.real.init()
        return self

    def __exit__(self, *exc):
        self.real.shutdown()

    def __getattr__(self, name):
        return getattr(self.real, name)

    def cc_state(self) -> dict:
        from tpu_cc_manager_torch.gpudev import standin_admin

        return standin_admin.cc_state(self.admin_dir)

    def cc_settings(self) -> dict:
        return self.cc_state()

    def cc_mode(self) -> str:
        from tpu_cc_manager_torch.gpudev.nvml import mode_from_state

        return mode_from_state(self.cc_state(), self.cc_settings())

    def handle_by_bdf(self, bdf: str):
        from tpu_cc_manager_torch.gpudev.nvml import NvmlError

        try:
            return self.real.handle_by_bdf(bdf)
        except NvmlError:
            for i in range(self.real.device_count()):
                handle = self.real.handle_by_index(i)
                if self.real.uuid(handle) == self.uuid_by_bdf.get(bdf):
                    return handle
            raise


def nvml_view(nvml) -> dict:
    """What the real NVML says of the system and of each GPU, with the
    return code of each call it refuses."""
    from tpu_cc_manager_torch.gpudev.nvml import NvmlError

    def attempt(fn, *args):
        try:
            return fn(*args)
        except NvmlError as e:
            return {"nvml_return_code": e.code}

    view = {"driver": nvml.driver_version(), "state": nvml.cc_state(),
            "capabilities": nvml.cc_capabilities(), "settings": attempt(nvml.cc_settings),
            "ready": attempt(nvml.gpus_ready_state), "gpus": []}
    for i in range(nvml.device_count()):
        handle = nvml.handle_by_index(i)
        view["gpus"].append({"index": i, "name": nvml.name(handle), "uuid": nvml.uuid(handle),
                             "bdf": attempt(nvml.bdf, handle),
                             "vbios": attempt(nvml.vbios_version, handle)})
    return view


def standin_h100(torch, directory, start_mode: str, by_bdf: dict, torch_uuid: dict,
                 fabric: bool, bus: bool):
    """``H100Backend`` over the card's BDFs with the stand-ins phase 15
    describes, under ``directory`` (emptied first): the gpu-admin-tools
    stand-in at ``start_mode``, NVML's CC state following it, and a sysfs
    tree of the same BDFs where the machine's sysfs has no PCI bus. Returns
    the backend and the stand-in admin library's directory."""
    import shutil

    from tpu_cc_manager_torch.gpudev import standin_admin
    from tpu_cc_manager_torch.gpudev.admin import AdminTools
    from tpu_cc_manager_torch.gpudev.h100 import H100Backend

    shutil.rmtree(directory, ignore_errors=True)
    admin_dir = directory / "admin"
    admin_dir.mkdir(parents=True)
    shutil.copy(standin_admin.__file__, admin_dir)
    names = {bdf: torch.cuda.get_device_name(i) for bdf, i in by_bdf.items()}
    # A card with no NVSwitch fabric cannot join a PPCIe domain.
    standin_admin.write_state(str(admin_dir), [
        standin_admin.device_state(bdf, names[bdf], cc=start_mode, ppcie_supported=fabric)
        for bdf in sorted(by_bdf)])
    sysfs_root = "/sys"
    if not bus:  # a stand-in tree of the same BDFs for the backend's sysfs scan
        sysfs_root = str(directory / "sys")
        for bdf in by_bdf:
            entry = directory / "sys" / "bus" / "pci" / "devices" / bdf
            entry.mkdir(parents=True)
            (entry / "vendor").write_text("0x10de\n")
            (entry / "class").write_text("0x030200\n")
    backend = H100Backend(state_dir=str(directory / "state"),
                          admin=AdminTools(path=str(admin_dir), module="standin_admin"),
                          nvml=FlipNvml(str(admin_dir), torch_uuid), sysfs_root=sysfs_root,
                          node_id="chip-smoke")
    return backend, admin_dir


def check_device_layer(torch, smi_line: str) -> dict:
    """Phase 15: the device layer (gpudev) on the card. Real discovery;
    then H100Backend flips off -> on -> devtools -> off through stand-ins
    for every part that would change the card, with the K1 matmul smoke as
    the verify after ``on``; the real card's attestation must be refused
    (CC off) and its CC state must end as it started. Returns the verify
    smoke's launch counts."""
    import pathlib
    import shutil

    from tpu_cc_manager_torch.gpudev import hostcaps, pci, standin_admin
    from tpu_cc_manager_torch.gpudev.contract import (
        MODE_DEVTOOLS,
        MODE_OFF,
        MODE_ON,
        MODE_PPCIE,
        GpuError,
    )
    from tpu_cc_manager_torch.gpudev.nvml import Nvml, NvmlError, mode_from_state
    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

    # --- real discovery: sysfs, NVML, torch ---
    t0 = time.perf_counter()
    found = pci.scan("/sys")
    discovery_ms = 1e3 * (time.perf_counter() - t0)
    bus = pci.pci_bus_present("/sys")
    t0 = time.perf_counter()
    with Nvml() as nvml:
        start = nvml_view(nvml)
    nvml_ms = 1e3 * (time.perf_counter() - t0)
    by_bdf = pci.torch_index_by_bdf()
    torch_uuid = {bdf: f"GPU-{torch.cuda.get_device_properties(i).uuid}"
                  for bdf, i in by_bdf.items()}
    start_mode = mode_from_state(start["state"], start["settings"])
    sys_gpus = sorted(f.bdf for f in found if f.kind == "gpu")
    switches = [f.bdf for f in found if f.kind == "nvswitch"]
    say(f"device layer: sysfs PCI bus {'present' if bus else 'absent'}; GPUs {sys_gpus}, "
        f"{len(switches)} NVSwitch(es); host CC {hostcaps.is_host_cc_enabled()}")
    say(f"device layer: NVML driver {start['driver']}, CC state {start['state']} "
        f"(environment {start['state']['environment']}, feature {start['state']['feature']}, "
        f"devtools {start['state']['devtools']}), capabilities {start['capabilities']}, "
        f"settings {start['settings']}, ready {start['ready']} -> mode {start_mode}")
    nvml_by_uuid = {g["uuid"]: g for g in start["gpus"]}
    for bdf, i in sorted(by_bdf.items()):
        g = nvml_by_uuid.get(torch_uuid[bdf])
        if g is None:
            fail(f"NVML lists no GPU with the UUID torch gives {bdf}")
        say(f"device layer: torch cuda:{i} {bdf} {torch.cuda.get_device_name(i)!r}; NVML by "
            f"UUID {({k: v for k, v in g.items() if k != 'uuid'})}; CC capable "
            f"{start['capabilities']['gpus'] == 1}, PPCIe capable {bool(switches)}")
        if g["name"] != torch.cuda.get_device_name(i):
            fail(f"{bdf}: NVML names it {g['name']!r}, torch {torch.cuda.get_device_name(i)!r}")
        if isinstance(g["bdf"], str) and g["bdf"] != bdf:
            fail(f"NVML places torch's {bdf} at {g['bdf']}")
    if len(start["gpus"]) != torch.cuda.device_count():
        fail(f"NVML counts {len(start['gpus'])} GPUs, torch {torch.cuda.device_count()}")
    if bus and sys_gpus != sorted(by_bdf):
        fail(f"sysfs lists GPUs {sys_gpus}, torch {sorted(by_bdf)}")
    nvml_bdfs = sorted(g["bdf"] for g in start["gpus"] if isinstance(g["bdf"], str))
    say(f"device layer: BDFs by torch {sorted(by_bdf)}; by sysfs "
        f"{sys_gpus if bus else 'none (no PCI bus in sysfs)'}; by NVML "
        f"{nvml_bdfs or [g['bdf'] for g in start['gpus']]}")
    say(f"device layer: discovery {discovery_ms:.3f} ms, NVML queries {nvml_ms:.3f} ms "
        f"({smi_line})")

    # --- the stand-in flip ---
    directory = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_gpudev"
    backend, admin_dir = standin_h100(torch, directory, start_mode, by_bdf, torch_uuid,
                                      bool(switches), bus)
    say(f"device layer: stand-ins: gpu-admin-tools ({admin_dir}/standin_admin.py), the NVML "
        f"CC state, {'the sysfs tree' if not bus else 'no sysfs'}; real: BDFs, names, NVML "
        "handles and attestation calls")
    topo = backend.discover()
    if sorted(d.bdf for d in topo.devices) != sorted(by_bdf):
        fail(f"H100Backend found {[d.bdf for d in topo.devices]}, torch {sorted(by_bdf)}")
    devices = topo.devices
    verify_launches = None
    for mode in (MODE_ON, MODE_DEVTOOLS, MODE_OFF):
        before = len(standin_admin.read_state(str(admin_dir))["calls"])
        seconds = {}
        t0 = time.perf_counter()
        backend.stage_cc_mode(devices, mode)
        seconds["stage"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend.reset(devices)
        seconds["reset"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend.wait_ready(devices, timeout_s=60)
        seconds["wait"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        verified = [backend.query_cc_mode(d) for d in devices]
        seconds["verify"] = time.perf_counter() - t0
        calls = standin_admin.read_state(str(admin_dir))["calls"][before:]
        order = [op for op, _, _ in calls if op in ("set_cc_mode", "reset_with_os",
                                                    "wait_for_boot")]
        n = len(devices)
        say(f"device layer: flip -> {mode}: verified {verified}; seconds "
            f"{json.dumps({k: round(v, 6) for k, v in seconds.items()})}; calls {calls}")
        if verified != [mode] * n:
            fail(f"the flip to {mode} verified {verified}")
        if order != ["set_cc_mode"] * n + ["reset_with_os"] * n + ["wait_for_boot"] * n:
            fail(f"the flip to {mode} broke the reference's order: {order}")
        if mode == MODE_ON:
            t0 = time.perf_counter()
            try:
                res = run_workload_subprocess("matmul", timeout_s=300,
                                              extra_args=["--kernel", "cuda"])
            except SmokeError as e:
                fail(f"device layer verify smoke: {e}")
            wall = time.perf_counter() - t0
            verify_launches = {**res["kernel_launches"],
                               **flat_variants(res["kernel_launches_by_variant"])}
            say(f"device layer: verify after on: matmul --kernel cuda ok={res['ok']} "
                f"devices={res['devices']} (torch {torch.cuda.device_count()}) "
                f"bdf={[c['bdf'] for c in res['per_device']]} blocks={res['blocks']} K1 sm90="
                f"{verify_launches['K1/sm90']} simt={verify_launches['K1/simt']}; child wall "
                f"{wall:.2f} s")
            check_devices("device layer verify smoke", res, torch.cuda.device_count())
            if res["per_device"][0]["bdf"] not in by_bdf:
                fail(f"the verify smoke's card {res['per_device'][0]['bdf']} is not one of "
                     f"{sorted(by_bdf)}")
            if verify_launches["K1/sm90"] <= 0 or verify_launches["K1/simt"] != 0:
                fail("the verify smoke did not launch K1, or not all on its sm90 kernel")
            if tiling_problem(res):
                fail(f"device layer verify smoke: {tiling_problem(res)}")
    try:
        backend.stage_cc_mode(devices, MODE_PPCIE)
        fail("ppcie was staged on a node where not every device supports it")
    except GpuError as e:
        say(f"device layer: ppcie refused: {e}")

    # --- the real card: no attestation with CC off, its mode untouched ---
    try:
        backend.fetch_attestation("chip-smoke-nonce")
        fail("fetch_attestation built a quote with the card's CC off")
    except NvmlError as e:
        say(f"device layer: fetch_attestation refused by {e.function}: NVML return code "
            f"{e.code}")
        if e.function != "nvmlDeviceGetConfComputeGpuAttestationReport":
            fail(f"fetch_attestation failed before the report: {e}")
    with Nvml() as nvml:
        end = nvml.cc_state()
    say(f"device layer: NVML CC state at the start {start['state']}, at the end {end}")
    if end != start["state"]:
        fail("the card's CC state changed during phase 15")
    shutil.rmtree(directory, ignore_errors=True)
    return verify_launches


def agent_pass(name: str, gpu, smoke_runner, directory, allow_fake_quotes=None,
               kube=None) -> list[dict]:
    """One pass of phase 16 (a): the port's ``CCManager`` over ``gpu``
    (behind ``ccmanager/node.py``) and ``kube`` (a new port ``FakeKube``
    by default), with the operator's component pods on the node and a
    reactor playing their DaemonSets (a paused component's pods go, a
    restored one's come back), flips ``AGENT_FLIPS``. Returns each flip's
    result, wall seconds, phase seconds and label tuples; the components
    must be back after each."""
    import threading

    from tpu_cc_manager_torch.ccmanager.intent_journal import IntentJournal
    from tpu_cc_manager_torch.ccmanager.manager import CCManager
    from tpu_cc_manager_torch.ccmanager.node import NodeBackend
    from tpu_cc_manager_torch.gpudev import hostcaps
    from tpu_cc_manager_torch.kubeclient.api import node_labels
    from tpu_cc_manager_torch.kubeclient.fake import FakeKube
    from tpu_cc_manager_torch.labels import DRAIN_COMPONENT_LABELS
    from tpu_cc_manager_torch.utils.metrics import MetricsRegistry

    kube = kube or FakeKube()
    kube.add_node(AGENT_NODE, {key: "true" for key in DRAIN_COMPONENT_LABELS})

    def pods() -> list:
        return sorted(p["metadata"]["name"] for p in kube.list_pods(AGENT_NS))

    def start_pod(app: str) -> None:
        kube.add_pod(AGENT_NS, f"{app}-{AGENT_NODE}", AGENT_NODE, labels={"app": app})

    for app in DRAIN_COMPONENT_LABELS.values():
        start_pod(app)
    all_pods = pods()
    # Reactors run on the patching thread (the manager re-admits on one of
    # its own), so they may run out of order: each patch is placed by its
    # resourceVersion, and the DaemonSets act on the node as it is now.
    patches = []  # (resourceVersion, label tuple)
    lock = threading.Lock()

    def on_patch(_node_name, node) -> None:
        patches.append((int(node["metadata"]["resourceVersion"]),
                        tuple(node_labels(node).get(k) for k in AGENT_LABEL_KEYS)))
        with lock:
            labels = node_labels(kube.get_node(AGENT_NODE))
            for key, app in DRAIN_COMPONENT_LABELS.items():
                if labels.get(key) != "true":
                    kube.delete_pods_matching(AGENT_NS, f"app={app}")
                elif not kube.list_pods(AGENT_NS, f"app={app}"):
                    start_pod(app)

    def steps_since(mark: int) -> list:
        ordered = [step for _, step in sorted(patches)]
        out, last = [], ordered[mark - 1] if mark else None
        for step in ordered[mark:]:
            if step != last:
                out.append(step)
            last = step
        return out

    kube.add_patch_reactor(on_patch)
    registry = MetricsRegistry()
    manager = CCManager(
        api=kube, backend=NodeBackend(gpu), node_name=AGENT_NODE,
        host_cc_capable=hostcaps.is_host_cc_enabled(), operator_namespace=AGENT_NS,
        evict_components=True, eviction_poll_interval_s=0.1, smoke_workload="matmul",
        smoke_runner=smoke_runner, allow_fake_quotes=allow_fake_quotes, metrics=registry,
        readiness_file=str(directory / f"ready-{name}"), state_dir=str(directory / name),
        intent_journal=IntentJournal.from_state_dir(str(directory / name)))
    flips = []
    for mode in AGENT_FLIPS:
        mark, reconciles = len(patches), len(registry.history)
        t0 = time.perf_counter()
        result = manager.set_cc_mode(mode)
        wall = time.perf_counter() - t0
        # A flip to the mode the node holds records no reconcile.
        phases = registry.last().phases if len(registry.history) > reconciles else []
        flip = {"pass": name, "mode": mode, "result": result, "wall_s": round(wall, 6),
                "phase_s": {p.name: round(p.seconds, 6) for p in phases},
                "failed_phases": [p.name for p in phases if not p.ok],
                "labels": steps_since(mark)}
        say(f"agent [{name}] flip -> {mode}: {json.dumps(flip)}")
        if pods() != all_pods or any(node_labels(kube.get_node(AGENT_NODE)).get(k) != "true"
                                     for k in DRAIN_COMPONENT_LABELS):
            fail(f"agent [{name}] flip -> {mode} left the components out: pods {pods()}")
        flips.append(flip)
    for event in kube.events:
        say(f"agent [{name}] event {event.get('reason')}: {event.get('message')}")
    labels = [f["labels"] for f in flips]
    if labels != AGENT_LABELS[name]:
        fail(f"agent [{name}] label sequence {labels} is not the JAX agent's "
             f"{AGENT_LABELS[name]}")
    return flips


def check_agent(torch, smi_line: str) -> dict:
    """Phase 16: the port's agent on the card. (a) In this process, over
    phase 15's stand-in rig (real discovery, ``H100Backend`` with the
    stand-in gpu-admin-tools), with the manager's own verifier, then over the
    port's fake node with fake quotes admitted; the verify smoke is K1's
    matmul smoke on the card. (b) ``python -m tpu_cc_manager_torch`` as a
    process against ``hack/mock_apiserver.py``: one flip to on, timed from
    the desired label to the ready label, then SIGTERM. Returns the verify
    smoke's launch counts."""
    import pathlib
    import shutil
    import signal

    from tpu_cc_manager_torch.ccmanager import localrig
    from tpu_cc_manager_torch.gpudev import pci
    from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend
    from tpu_cc_manager_torch.gpudev.nvml import Nvml, mode_from_state
    from tpu_cc_manager_torch.labels import (
        CC_MODE_LABEL,
        CC_MODE_STATE_LABEL,
        CC_READY_STATE_LABEL,
    )
    from tpu_cc_manager_torch.smoke.runner import run_workload_subprocess
    from tpu_cc_manager_torch.utils.launch import free_port

    directory = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_agent"
    found = pci.scan("/sys")
    by_bdf = pci.torch_index_by_bdf()
    torch_uuid = {bdf: f"GPU-{torch.cuda.get_device_properties(i).uuid}"
                  for bdf, i in by_bdf.items()}
    with Nvml() as nvml:
        start = nvml_view(nvml)
    start_mode = mode_from_state(start["state"], start["settings"])
    switches = [f.bdf for f in found if f.kind == "nvswitch"]
    gpu, _ = standin_h100(torch, directory, start_mode, by_bdf, torch_uuid, bool(switches),
                          pci.pci_bus_present("/sys"))
    smokes = []

    def smoke(workload: str) -> dict:
        res = run_workload_subprocess(workload, timeout_s=300, extra_args=["--kernel", "cuda"])
        smokes.append(res)
        return res

    # --- (a) in process: the h100 pass, then the fake pass ---
    # Every flip that changes the mode ends with the verify smoke, the flip
    # to off too; the first flip (off on a node at off) changes nothing.
    h100 = agent_pass("h100", gpu, smoke, directory)
    if [f["result"] for f in h100] != [True, False, True]:
        fail(f"agent [h100]: results {[f['result'] for f in h100]}, want [True, False, True]")
    if h100[1]["failed_phases"] != ["attest"] or "smoke" in h100[1]["phase_s"]:
        fail("agent [h100]: the flip to on did not fail at its attestation, before the smoke")
    with Nvml() as nvml:
        end = nvml.cc_state()
    say(f"agent [h100]: NVML CC state at the start {start['state']}, at the end {end}")
    if end != start["state"]:
        fail("the card's CC state changed during phase 16")
    fake = FakeGpuBackend(num_gpus=len(by_bdf), num_switches=len(switches),
                          node_id="chip-smoke")
    flips = agent_pass("fake", fake, smoke, directory, allow_fake_quotes=True)
    if [f["result"] for f in flips] != [True, True, True]:
        fail(f"agent [fake]: results {[f['result'] for f in flips]}, want [True, True, True]")
    runs = [f"{f['pass']} {f['mode']}" for f in h100 + flips if "smoke" in f["phase_s"]]
    if runs != ["h100 off", "fake on", "fake off"] or len(smokes) != len(runs):
        fail(f"agent: verify smokes after {runs} ({len(smokes)} run), want after "
             "h100 off, fake on, fake off")
    launches = {}
    for run, res in zip(runs, smokes):
        counts = {**res["kernel_launches"], **flat_variants(res["kernel_launches_by_variant"])}
        say(f"agent: verify smoke after {run}: ok={res['ok']} devices={res['devices']} "
            f"blocks={res['blocks']} K1 sm90={counts['K1/sm90']} simt={counts['K1/simt']}")
        check_devices(f"agent verify smoke after {run}", res, torch.cuda.device_count())
        if counts["K1/sm90"] <= 0 or counts["K1/simt"] != 0:
            fail("the agent's verify smoke did not launch K1, or not all on its sm90 kernel")
        if tiling_problem(res):
            fail(f"the agent's verify smoke after {run}: {tiling_problem(res)}")
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    say(f"agent [fake]: flip -> on drain->ready {flips[1]['wall_s']:.3f} s (in process, drain "
        f"poll 0.1 s; budget {AGENT_BUDGET_S:g} s; {smi_line})")

    # --- (b) the CLI as a process against the mock apiserver ---
    metrics_port = free_port()
    with localrig.LocalRig(str(directory / "rig")) as rig:
        agent = rig.start_agent(
            ["--gpu-backend", "fake", "--smoke-workload", "matmul"], metrics_port=metrics_port,
            env={"GPU_CC_FAKE_NUM_GPUS": str(len(by_bdf)),
                 "GPU_CC_FAKE_NUM_SWITCHES": str(len(switches))})
        # The host is not CC capable, so the agent first applies its default, off.
        if not rig.await_labels({CC_MODE_STATE_LABEL: "off"}, 60):
            fail(f"agent CLI: no initial reconcile: {rig.log_of(agent)[-3000:]}")
        t0 = time.perf_counter()
        rig.set_label(CC_MODE_LABEL, "on")
        ready = rig.await_labels({CC_MODE_STATE_LABEL: "on", CC_READY_STATE_LABEL: "true"},
                                 AGENT_FLIP_TIMEOUT_S)
        drain_to_ready = time.perf_counter() - t0
        if not ready:
            fail(f"agent CLI: no flip to on in {AGENT_FLIP_TIMEOUT_S} s: "
                 f"{rig.log_of(agent)[-3000:]}")
        t0 = time.perf_counter()
        phases, text = localrig.await_phases(metrics_port, "on", AGENT_PHASES, 30)
        recorded_after = time.perf_counter() - t0
        reconcile = [line for line in text.splitlines()
                     if line.startswith('tpu_cc_reconcile_seconds{mode="on"')]
        say(f"agent CLI: python -m tpu_cc_manager_torch --gpu-backend fake --smoke-workload "
            f"matmul: drain->ready {drain_to_ready:.3f} s (budget {AGENT_BUDGET_S:g} s; "
            f"{smi_line}); tpu_cc_phase_seconds {json.dumps(phases)}, read "
            f"{recorded_after:.3f} s after the ready label; {reconcile}")
        if not set(AGENT_PHASES) <= set(phases):
            fail(f"agent CLI: phases {sorted(phases)} miss one of the flip's")
        cli_smokes = smoke_results_in(rig.log_of(agent))
        say(f"agent CLI: verify smoke blocks {[res.get('blocks') for res in cli_smokes]}")
        if len(cli_smokes) != 1 or tiling_problem(cli_smokes[0]):
            fail(f"agent CLI: {len(cli_smokes)} verify smokes logged, want 1 at the default "
                 f"tiling: {[tiling_problem(res) for res in cli_smokes]}")
        t0 = time.perf_counter()
        agent.send_signal(signal.SIGTERM)
        try:
            rc = agent.wait(timeout=30)
        except subprocess.TimeoutExpired:
            rc = None
        say(f"agent CLI: SIGTERM -> exit {rc} in {time.perf_counter() - t0:.3f} s")
        if rc != 0:
            fail(f"agent CLI: SIGTERM gave exit {rc}: {rig.log_of(agent)[-3000:]}")
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def pool_agents(kube, node_labels_of: dict, smoke_runner, directory) -> dict:
    """One port agent per node of ``node_labels_of`` (name -> extra labels):
    each node an HGX ``FakeGpuBackend`` behind ``NodeBackend`` with the
    operator's pods from ``drain/sim.py``, its ``CCManager.watch_and_apply``
    on a thread over ``kube``, verifying every flip with ``smoke_runner``.
    Each node's desired label is stamped when it first reads on, and its
    ready when it first reads ``mode.state=on`` with ``ready.state=true``
    (patch reactors run on the patching thread, so each stamp is taken as
    the patch lands). Returns the pool's state; ``start`` starts the agents
    and waits until every node settled at off with its slice id published
    (False when they never did), ``stop`` stops them."""
    import threading

    from tpu_cc_manager_torch.ccmanager.manager import CCManager
    from tpu_cc_manager_torch.ccmanager.node import NodeBackend
    from tpu_cc_manager_torch.drain.sim import add_drainable_node
    from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend
    from tpu_cc_manager_torch.kubeclient.api import node_labels
    from tpu_cc_manager_torch.labels import (
        CC_MODE_LABEL,
        CC_MODE_STATE_LABEL,
        CC_READY_STATE_LABEL,
        MODE_OFF,
        MODE_ON,
        SLICE_ID_LABEL,
    )
    from tpu_cc_manager_torch.obs.journal import Journal
    from tpu_cc_manager_torch.utils.metrics import MetricsRegistry
    from tpu_cc_manager_torch.utils.poll import poll_until

    directory.mkdir(parents=True, exist_ok=True)
    nodes = list(node_labels_of)
    pool = {"nodes": nodes, "gpus": {}, "registries": {}, "smokes": [], "desired_at": {},
            "ready_at": {}}
    lock = threading.Lock()

    def on_patch(name, node) -> None:
        labels, now = node_labels(node), time.perf_counter()
        with lock:
            if labels.get(CC_MODE_LABEL) == MODE_ON:
                pool["desired_at"].setdefault(name, now)
            if labels.get(CC_MODE_STATE_LABEL) == MODE_ON and \
                    labels.get(CC_READY_STATE_LABEL) == "true":
                pool["ready_at"].setdefault(name, now)

    stop, threads = threading.Event(), []
    for name, extra in node_labels_of.items():
        add_drainable_node(kube, name, AGENT_NS, extra_labels=dict(extra))
        pool["gpus"][name] = FakeGpuBackend(node_id=name)
        pool["registries"][name] = MetricsRegistry()

        def smoke(workload: str, _node: str = name) -> dict:
            t0 = time.perf_counter()
            res = smoke_runner(workload)
            with lock:
                pool["smokes"].append({"node": _node, "t0": t0, "t1": time.perf_counter(),
                                       "result": res})
            return res

        agent = CCManager(
            api=kube, backend=NodeBackend(pool["gpus"][name]), node_name=name,
            default_mode=MODE_OFF, operator_namespace=AGENT_NS, evict_components=True,
            eviction_poll_interval_s=0.02, smoke_workload="matmul", smoke_runner=smoke,
            allow_fake_quotes=True, metrics=pool["registries"][name],
            journal=Journal(trace_file=""), watch_timeout_s=1, reconnect_delay_s=0.0,
            readiness_file=str(directory / f"ready-{name}"))
        threads.append(threading.Thread(target=agent.watch_and_apply, args=(stop,),
                                        daemon=True, name=f"agent-{name}"))
    kube.add_patch_reactor(on_patch)

    def start() -> bool:
        for thread in threads:
            thread.start()
        # The agents settle at off and publish their slice ids, which the
        # orchestrator groups by: one node per group.
        return poll_until(lambda: all(
            node_labels(kube.get_node(n)).get(CC_MODE_STATE_LABEL) == MODE_OFF
            and node_labels(kube.get_node(n)).get(SLICE_ID_LABEL) for n in nodes), 60, 0.05)

    def stop_agents() -> None:
        stop.set()
        for thread in threads:
            thread.join(timeout=10)

    pool["start"], pool["stop"] = start, stop_agents
    return pool


def rolling_pool(smoke_runner, directory) -> dict:
    """Phase 17's rollout: ``POOL_NODES`` port agents (``pool_agents``)
    verify every flip with ``smoke_runner``. The port's
    ``RollingReconfigurator`` flips the pool to on with
    ``max_unavailable=1`` under a ``RolloutLease`` and a ``FlightRecorder``;
    it is killed (``OrchestratorKilled``) at the first window boundary, and
    a successor takes the lease over, reads the record and resumes. Then one
    patch goes through the killed orchestrator's ``FencedKube``. Returns the
    results, timings and observations the phase checks."""
    from tpu_cc_manager_torch.ccmanager import rollout_state
    from tpu_cc_manager_torch.ccmanager.rolling import RollingReconfigurator
    from tpu_cc_manager_torch.faults.plan import OrchestratorKilled
    from tpu_cc_manager_torch.kubeclient.api import node_labels
    from tpu_cc_manager_torch.kubeclient.fake import FakeKube
    from tpu_cc_manager_torch.labels import CC_MODE_LABEL, MODE_OFF, MODE_ON
    from tpu_cc_manager_torch.obs import flight as flight_mod
    from tpu_cc_manager_torch.utils.metrics import MetricsRegistry

    kube = FakeKube()
    nodes = [f"pool-node-{i}" for i in range(POOL_NODES)]
    selector = "=".join(POOL_LABEL)
    agents = pool_agents(kube, {name: [POOL_LABEL] for name in nodes}, smoke_runner, directory)
    gpus, smokes = agents["gpus"], agents["smokes"]
    desired_at, ready_at = agents["desired_at"], agents["ready_at"]
    try:
        if not agents["start"]():
            return {"error": "the pool's agents never settled at off"}
        metrics = MetricsRegistry()
        flight_path = str(directory / "flight.jsonl")

        def orchestrator(holder: str, record=None):
            lease = rollout_state.RolloutLease(kube, holder=holder, namespace=AGENT_NS,
                                               duration_s=POOL_LEASE_S, metrics=metrics)
            deadline = time.perf_counter() + 4 * POOL_LEASE_S
            while True:
                try:
                    record = lease.acquire()
                    break
                except rollout_state.LeaseHeld:
                    if time.perf_counter() > deadline:
                        raise
                    time.sleep(0.02)
            acquired = time.perf_counter()
            lease.start_renewer()
            flight = flight_mod.FlightRecorder(flight_path, generation=lease.generation)
            flight.record(flight_mod.EVENT_LEASE_ACQUIRED, holder=holder,
                          resumed=record is not None or None)
            return lease, record, acquired, flight

        def killer(point: str) -> None:
            if point == POOL_KILL_POINT:
                raise OrchestratorKilled(point, 0)

        t0 = time.perf_counter()
        lease_a, _, _, flight_a = orchestrator("chip-smoke-orchestrator-a")
        first = RollingReconfigurator(
            kube, selector, max_unavailable=1, node_timeout_s=POOL_NODE_TIMEOUT_S,
            poll_interval_s=0.05, lease=lease_a, crash_hook=killer, flight=flight_a,
            metrics=metrics)
        try:
            first.rollout(MODE_ON)
            return {"error": f"the first orchestrator was not killed at {POOL_KILL_POINT}"}
        except OrchestratorKilled:
            killed = time.perf_counter()
        lease_a.stop_renewer()  # a killed process renews nothing; nothing is released
        converged_before_kill = sorted(ready_at)
        lease_b, record, acquired, flight_b = orchestrator("chip-smoke-orchestrator-b")
        if record is None:
            return {"error": "the successor found no rollout record in the lease"}
        done_in_record = sorted(g for g, d in record.done.items() if d.get("ok"))
        successor = RollingReconfigurator(
            kube, selector, max_unavailable=1, node_timeout_s=POOL_NODE_TIMEOUT_S,
            poll_interval_s=0.05, lease=lease_b, resume_record=record, flight=flight_b,
            metrics=metrics)
        result = successor.rollout(MODE_ON)
        wall = time.perf_counter() - t0
        lease_b.stop_renewer()
        # The killed orchestrator's fence: its writes are refused and counted.
        fenced_before = metrics.rollout_totals()["fenced_writes"]
        try:
            first.api.patch_node_labels(nodes[0], {CC_MODE_LABEL: MODE_OFF})
            fenced = False
        except rollout_state.RolloutFenced:
            fenced = True
        exposition = metrics.render_prometheus()
        lease_b.release(clear_record=result.ok)
    finally:
        agents["stop"]()
    events, torn = flight_mod.read_events(flight_path)
    return {
        "result": result, "wall_s": wall, "killed_s": killed - t0,
        "takeover_gap_s": acquired - killed, "generations": (lease_a.generation,
                                                             lease_b.generation),
        "converged_before_kill": converged_before_kill, "done_in_record": done_in_record,
        "nodes": nodes, "desired_at": desired_at, "ready_at": ready_at, "smokes": smokes,
        "labels": {n: node_labels(kube.get_node(n)) for n in nodes},
        "committed": {n: (set(g.committed_cc.values()), set(g.committed_ppcie.values()))
                      for n, g in gpus.items()},
        "fenced": fenced, "fenced_writes": (fenced_before,
                                            metrics.rollout_totals()["fenced_writes"]),
        "exposition": exposition, "torn_lines": torn,
        "timeline": flight_mod.reconstruct(events), "t0": t0,
    }


def pool_problems(pool: dict) -> list[str]:
    """What phase 17 requires of a ``rolling_pool`` run, as a list of the
    requirements that failed (empty when every one held)."""
    from tpu_cc_manager_torch.labels import (
        CC_MODE_STATE_LABEL,
        CC_READY_STATE_LABEL,
        MODE_ON,
    )
    from tpu_cc_manager_torch.obs.flight import EVENT_NODE_CONVERGED

    if "error" in pool:
        return [pool["error"]]
    problems = []
    result, nodes = pool["result"], pool["nodes"]
    if not result.ok:
        problems.append(f"the resumed rollout failed: {result.summary()}")
    if not result.resumed or pool["generations"][1] <= pool["generations"][0]:
        problems.append(f"no fenced takeover: resumed={result.resumed} "
                        f"generations={pool['generations']}")
    if pool["converged_before_kill"] != nodes[:1] or pool["done_in_record"] != nodes[:1]:
        problems.append(f"the kill did not land after group 1 alone: converged "
                        f"{pool['converged_before_kill']}, record {pool['done_in_record']}")
    for name in nodes:
        modes, ppcie = pool["committed"][name]
        labels = pool["labels"][name]
        if modes != {MODE_ON} or ppcie != {"off"}:
            problems.append(f"{name}: committed CC {sorted(modes)}, PPCIe {sorted(ppcie)}")
        if labels.get(CC_MODE_STATE_LABEL) != MODE_ON or \
                labels.get(CC_READY_STATE_LABEL) != "true":
            problems.append(f"{name}: labels end at {labels.get(CC_MODE_STATE_LABEL)}, "
                            f"ready {labels.get(CC_READY_STATE_LABEL)}")
    if result.max_unavailable_observed != 1:
        problems.append(f"max_unavailable_observed {result.max_unavailable_observed}, want 1")
    spans = sorted((pool["desired_at"][n], pool["ready_at"].get(n, float("inf")))
                   for n in nodes if n in pool["desired_at"])
    if len(spans) != len(nodes) or any(b[0] < a[1] for a, b in zip(spans, spans[1:])):
        problems.append("two nodes were out of service at once (desired on, not yet ready)")
    smokes = sorted(pool["smokes"], key=lambda s: s["t0"])
    if sorted(s["node"] for s in smokes) != nodes:
        problems.append(f"smokes ran on {[s['node'] for s in smokes]}, want each node once")
    if any(b["t0"] < a["t1"] for a, b in zip(smokes, smokes[1:])):
        problems.append("two smoke children overlapped")
    if pool["torn_lines"]:
        problems.append(f"{pool['torn_lines']} torn flight lines")
    timeline = pool["timeline"]
    outcomes = {n: e["outcome"] for n, e in timeline["nodes"].items() if not e["skipped"]}
    if outcomes != {n: EVENT_NODE_CONVERGED for n in nodes} or \
            timeline["duplicate_node_events"]:
        problems.append(f"the flight timeline does not show each node converged once: "
                        f"{timeline['nodes']} duplicates {timeline['duplicate_node_events']}")
    if not pool["fenced"] or pool["fenced_writes"] != (0, 1) or \
            "tpu_cc_rollout_fenced_writes_total 1" not in pool["exposition"]:
        problems.append(f"the killed orchestrator's patch was not refused and counted once: "
                        f"fenced={pool['fenced']} counts {pool['fenced_writes']}")
    return problems


def node_smokes(tag: str, pool: dict, smoke_k1: int, problems: list) -> dict:
    """Print each node's desired on -> ready wall against the per-node
    budget, its verify smoke's wall and share and its K1 launches; append to
    ``problems`` a node over the budget, a failed smoke and a smoke whose K1
    launches are not ``smoke_k1``, all on ``sm90``. Returns the smokes'
    launch counts, summed."""
    smokes = {s["node"]: s for s in pool["smokes"]}
    launches = {}
    for name in pool["nodes"]:
        node_s = pool["ready_at"].get(name, float("nan")) - pool["desired_at"].get(name, float("nan"))
        s = smokes.get(name)
        smoke_s = s["t1"] - s["t0"] if s else float("nan")
        say(f"{tag}: {name} desired on -> ready {node_s:.3f} s (budget "
            f"{AGENT_BUDGET_S:g} s per node), smoke {smoke_s:.3f} s, smoke share "
            f"{smoke_s / node_s:.4f}")
        if not node_s < AGENT_BUDGET_S:
            problems.append(f"{name} took {node_s:.3f} s, over the {AGENT_BUDGET_S:g} s budget")
        if s is None:
            continue
        res = s["result"]
        if not res.get("ok"):
            problems.append(f"{name}'s verify smoke failed: {json.dumps(res, default=str)[:500]}")
            continue
        counts = {"K1/sm90": 0, "K1/simt": 0, **res.get("kernel_launches", {}),
                  **flat_variants(res.get("kernel_launches_by_variant", {}))}
        say(f"{tag}: {name} verify smoke ok={res['ok']} devices={res.get('devices')} "
            f"blocks={res.get('blocks')} K1 sm90={counts['K1/sm90']} simt={counts['K1/simt']}")
        # Every card the smoke child saw.
        check_devices(f"{tag} verify smoke on {name}", res, res.get("visible_devices", 1))
        if counts["K1/sm90"] != smoke_k1 or counts["K1/simt"] != 0:
            problems.append(f"{name}'s verify smoke made K1 sm90={counts['K1/sm90']} "
                            f"simt={counts['K1/simt']}, want {smoke_k1} on sm90")
        if tiling_problem(res):
            problems.append(f"{name}'s verify smoke: {tiling_problem(res)}")
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    return launches


def check_rolling_pool(torch, smi_line: str, smoke_k1: int) -> dict:
    """Phase 17: ``rolling_pool`` with K1's matmul smoke on the card as each
    node's verify smoke. Every requirement of ``pool_problems`` must hold,
    and each smoke must make ``smoke_k1`` K1 launches (phase 5's matmul
    smoke), all on ``sm90``. Returns the smokes' launch counts."""
    import pathlib
    import shutil

    from tpu_cc_manager_torch.smoke.runner import run_workload_subprocess

    def smoke(workload: str) -> dict:
        return run_workload_subprocess(workload, timeout_s=300, extra_args=["--kernel", "cuda"])

    directory = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_pool"
    shutil.rmtree(directory, ignore_errors=True)
    pool = rolling_pool(smoke, directory)
    problems = pool_problems(pool)
    if "error" in pool:
        fail(f"rolling pool: {pool['error']}")
    say(f"rolling pool: {POOL_NODES} fake HGX nodes (8 GPUs, 4 NVSwitches each) flipped to on, "
        f"max_unavailable 1: wall {pool['wall_s']:.3f} s; orchestrator killed at "
        f"{POOL_KILL_POINT} {pool['killed_s']:.3f} s in, after {pool['converged_before_kill']}; "
        f"takeover gap {pool['takeover_gap_s']:.3f} s (lease {POOL_LEASE_S:g} s), generations "
        f"{pool['generations']}; {smi_line}")
    say(f"rolling pool: result {json.dumps(pool['result'].summary())}")
    launches = node_smokes("rolling pool", pool, smoke_k1, problems)
    timeline = pool["timeline"]
    say(f"rolling pool: flight torn lines {pool['torn_lines']}, generations "
        f"{timeline['generations']}, resumes {timeline['resumes']}, node outcomes "
        f"{json.dumps({n: e['outcome'] for n, e in timeline['nodes'].items()})}; fenced patch "
        f"refused={pool['fenced']}, tpu_cc_rollout_fenced_writes_total {pool['fenced_writes'][1]}")
    if problems:
        fail("rolling pool: " + "; ".join(problems))
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def federated_pool(smoke_runner, directory) -> dict:
    """Phase 18's rollout: one port agent (``pool_agents``) per region of
    ``FED_REGIONS``, each node labelled with its region, verifying every
    flip with ``smoke_runner``. The port's operator CLI flips the pool to on
    as ``ctl rollout --regions`` does: ``ctl.cmd_rollout`` with the
    in-process ``FakeKube``, one lease-fenced shard per region under one
    parent record and a global failure budget. ctl's orchestrator is
    wrapped so that, in the first run, the ``FED_KILL_REGION`` shard is
    killed (``OrchestratorKilled``) at ``FED_KILL_POINT``; ``rollout
    --resume --regions`` then resumes it. Then one patch goes through the
    killed shard's ``FencedKube``; ``ctl rollout-timeline --stitch`` renders
    the regional flight files; a ``FleetGateway`` over the agents'
    registries serves ``/metrics`` and ``/fleetz``; and ``ctl status``
    lists the pool. Returns the results, timings and observations the phase
    checks."""
    import contextlib
    import io
    import urllib.request

    from tpu_cc_manager_torch import ctl
    from tpu_cc_manager_torch.ccmanager import federation, rollout_state
    from tpu_cc_manager_torch.faults.plan import OrchestratorKilled
    from tpu_cc_manager_torch.kubeclient.api import node_labels
    from tpu_cc_manager_torch.kubeclient.fake import FakeKube
    from tpu_cc_manager_torch.labels import CC_MODE_LABEL, MODE_OFF
    from tpu_cc_manager_torch.lint import expo
    from tpu_cc_manager_torch.obs import fleet
    from tpu_cc_manager_torch.obs import flight as flight_mod
    from tpu_cc_manager_torch.utils import metrics as metrics_mod

    kube = FakeKube()
    region_of = {f"fed-node-{region}": region for region in FED_REGIONS}
    nodes = list(region_of)
    selector = "=".join(FED_LABEL)
    agents = pool_agents(kube, {name: [FED_LABEL, (federation.REGION_LABEL, region)]
                                for name, region in region_of.items()}, smoke_runner, directory)
    shard_region = {federation.regional_selector(selector, r): r for r in FED_REGIONS}
    flight_file = str(directory / "flight.jsonl")
    flight_files = [f"{flight_file}.{region}" for region in FED_REGIONS]
    common = ["--selector", selector, "--node-timeout", str(POOL_NODE_TIMEOUT_S),
              "--lease-namespace", AGENT_NS, "--lease-duration", str(POOL_LEASE_S),
              "--flight-file", flight_file]
    shards = []  # every orchestrator shard ctl built, in order

    class Shard(ctl.RollingReconfigurator):
        """ctl's orchestrator, noted as ctl builds each shard; in the first
        run the ``FED_KILL_REGION`` shard carries a crash hook."""
        run = 1

        def __init__(self, api, shard_selector, **kwargs):
            region = shard_region[shard_selector]
            if Shard.run == 1 and region == FED_KILL_REGION:
                def killer(point: str) -> None:
                    if point == FED_KILL_POINT:
                        raise OrchestratorKilled(point, 0)

                kwargs["crash_hook"] = killer
            super().__init__(api, shard_selector, **kwargs)
            shards.append({"run": Shard.run, "region": region, "roller": self,
                           "built": time.perf_counter(),
                           "resume_record": kwargs.get("resume_record")})

    def cli(command, argv: list) -> tuple[int, str]:
        """One ``ctl`` command on the pool's ``FakeKube``, its standard
        output kept."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = command(kube, ctl.build_parser().parse_args(argv))
        return rc, out.getvalue()

    def fetch(url: str) -> str:
        with urllib.request.urlopen(url, timeout=30) as response:
            return response.read().decode()

    try:
        if not agents["start"]():
            return {"error": "the federated pool's agents never settled at off"}
        original, ctl.RollingReconfigurator = ctl.RollingReconfigurator, Shard
        try:
            t0 = time.perf_counter()
            try:
                cli(ctl.cmd_rollout, ["rollout", *common, "--mode", "on", "--regions",
                                      ",".join(FED_REGIONS), "--failure-budget", str(FED_BUDGET)])
                return {"error": f"the {FED_KILL_REGION} shard was not killed at {FED_KILL_POINT}"}
            except OrchestratorKilled:
                killed = time.perf_counter()
            converged_before_kill = sorted(agents["ready_at"])
            Shard.run = 2
            rc, out = cli(ctl.cmd_rollout, ["rollout", *common, "--resume", "--regions",
                                            ",".join(FED_REGIONS)])
            wall = time.perf_counter() - t0
        finally:
            ctl.RollingReconfigurator = original
        summary = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
        parent = federation.ParentStore(kube, namespace=AGENT_NS).load()
        first = next(s for s in shards if s["run"] == 1 and s["region"] == FED_KILL_REGION)
        resumed = next(s for s in shards if s["run"] == 2 and s["region"] == FED_KILL_REGION)
        record = resumed["resume_record"]
        # The killed shard's fence: its writes are refused and counted.
        fenced_before = metrics_mod.REGISTRY.rollout_totals()["fenced_writes"]
        try:
            first["roller"].api.patch_node_labels(nodes[0], {CC_MODE_LABEL: MODE_OFF})
            fenced = False
        except rollout_state.RolloutFenced:
            fenced = True
        fenced_after = metrics_mod.REGISTRY.rollout_totals()["fenced_writes"]
        timeline_rc, timeline_text = cli(ctl.cmd_rollout_timeline,
                                         ["rollout-timeline", "--stitch", *flight_files])
        status_rc, status_text = cli(ctl.cmd_status, ["status", "--selector", selector,
                                                      "--lease-namespace", AGENT_NS])
        gateway = fleet.FleetGateway({name: fleet.local_target(agents["registries"][name])
                                      for name in nodes})
        swept = time.perf_counter()
        gateway.scrape_once()
        sweep_ms = (time.perf_counter() - swept) * 1e3
        node_texts = {name: agents["registries"][name].render_prometheus() for name in nodes}
        server = gateway.serve(0)
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            merged, fleetz = fetch(f"{base}/metrics"), json.loads(fetch(f"{base}/fleetz"))
        finally:
            server.shutdown()
            server.server_close()
    finally:
        agents["stop"]()
    events, torn = flight_mod.stitch_files(flight_files)
    return {
        "rc": rc, "summary": summary, "wall_s": wall, "killed_s": killed - t0,
        "takeover_gap_s": resumed["built"] - killed,
        "converged_before_kill": converged_before_kill,
        "resume_digest": (record.federation or {}).get("digest") if record is not None else None,
        "parent": json.loads(parent.to_json()) if parent is not None else None,
        "nodes": nodes, "region_of": region_of, "desired_at": agents["desired_at"],
        "ready_at": agents["ready_at"], "smokes": agents["smokes"],
        "labels": {n: node_labels(kube.get_node(n)) for n in nodes},
        "committed": {n: (set(g.committed_cc.values()), set(g.committed_ppcie.values()))
                      for n, g in agents["gpus"].items()},
        "fenced": fenced, "fenced_writes": (fenced_before, fenced_after),
        "timeline_rc": timeline_rc, "timeline_text": timeline_text, "torn_lines": torn,
        "timeline": flight_mod.reconstruct(events), "status_rc": status_rc,
        "status_text": status_text, "node_texts": node_texts, "merged": merged,
        "expo_problems": expo.lint(merged), "fleetz": fleetz, "sweep_ms": sweep_ms,
    }


def phase_seconds_mismatches(node_texts: dict, merged: str) -> list[str]:
    """The ``tpu_cc_phase_seconds`` ``_count`` and ``_sum`` series of the
    merged exposition that differ from the sum of the nodes' (compared as
    the exposition writes them), and the series of either side that the
    other lacks. Empty when every one is exact."""
    from tpu_cc_manager_torch.obs import fleet

    def series(text: str) -> dict:
        return {(name, tuple(sorted(labels))): value
                for name, labels, value in fleet.parse_exposition(text).samples
                if name in ("tpu_cc_phase_seconds_count", "tpu_cc_phase_seconds_sum")}

    want: dict = {}
    for text in node_texts.values():
        for key, value in series(text).items():
            want[key] = want.get(key, 0.0) + value
    got = series(merged)
    if not want:
        return ["the nodes export no tpu_cc_phase_seconds series"]
    return [f"{name}{dict(labels)}: merged {got.get((name, labels))}, nodes sum "
            f"{want.get((name, labels))}"
            for name, labels in sorted(set(want) | set(got))
            if (name, labels) not in got or (name, labels) not in want
            or fleet._format_value(got[(name, labels)]) !=
            fleet._format_value(want[(name, labels)])]


def federated_problems(fed: dict) -> list[str]:
    """What phase 18 requires of a ``federated_pool`` run, as a list of the
    requirements that failed (empty when every one held)."""
    from tpu_cc_manager_torch.labels import (
        CC_MODE_STATE_LABEL,
        CC_READY_STATE_LABEL,
        MODE_ON,
    )
    from tpu_cc_manager_torch.obs.flight import EVENT_NODE_CONVERGED

    if "error" in fed:
        return [fed["error"]]
    problems = []
    nodes, summary, parent = fed["nodes"], fed["summary"], fed["parent"] or {}
    killed_node = next(n for n, r in fed["region_of"].items() if r == FED_KILL_REGION)
    if fed["rc"] != 0 or not summary.get("ok") or summary.get("parent_status") != "complete":
        problems.append(f"the resumed federated rollout failed: rc {fed['rc']} {summary}")
    if not (summary.get("regions") or {}).get(FED_KILL_REGION, {}).get("resumed"):
        problems.append(f"the {FED_KILL_REGION} shard did not resume its record: {summary}")
    if fed["resume_digest"] is None or fed["resume_digest"] != parent.get("digest"):
        problems.append(f"the resumed shard's record is not the parent's: digest "
                        f"{fed['resume_digest']}, parent {parent.get('digest')}")
    if fed["converged_before_kill"] != sorted(set(nodes) - {killed_node}):
        problems.append(f"the kill did not land before {killed_node} was touched: converged "
                        f"{fed['converged_before_kill']}")
    regions = parent.get("regions") or {}
    if sorted(regions) != sorted(FED_REGIONS) or any(
            (r.get("status"), r.get("done"), r.get("total")) != ("complete", 1, 1)
            for r in regions.values()):
        problems.append(f"the parent record does not count each region's node once: {regions}")
    if parent.get("budget_spend") != [] or parent.get("failure_budget") != FED_BUDGET:
        problems.append(f"the parent record charged the budget: spend "
                        f"{parent.get('budget_spend')} of {parent.get('failure_budget')}")
    for name in nodes:
        modes, ppcie = fed["committed"][name]
        labels = fed["labels"][name]
        if modes != {MODE_ON} or ppcie != {"off"}:
            problems.append(f"{name}: committed CC {sorted(modes)}, PPCIe {sorted(ppcie)}")
        if labels.get(CC_MODE_STATE_LABEL) != MODE_ON or \
                labels.get(CC_READY_STATE_LABEL) != "true":
            problems.append(f"{name}: labels end at {labels.get(CC_MODE_STATE_LABEL)}, "
                            f"ready {labels.get(CC_READY_STATE_LABEL)}")
    if sorted(s["node"] for s in fed["smokes"]) != nodes:
        problems.append(f"smokes ran on {[s['node'] for s in fed['smokes']]}, want each node once")
    if not fed["fenced"] or fed["fenced_writes"][1] != fed["fenced_writes"][0] + 1:
        problems.append(f"the killed shard's patch was not refused and counted once: "
                        f"fenced={fed['fenced']} counts {fed['fenced_writes']}")
    if fed["timeline_rc"] != 0 or not fed["timeline_text"].startswith("flight recorder:"):
        problems.append(f"ctl rollout-timeline --stitch failed: rc {fed['timeline_rc']}")
    if fed["torn_lines"]:
        problems.append(f"{fed['torn_lines']} torn flight lines")
    timeline = fed["timeline"]
    outcomes = {n: e["outcome"] for n, e in timeline["nodes"].items() if not e["skipped"]}
    if outcomes != {n: EVENT_NODE_CONVERGED for n in nodes} or \
            timeline["duplicate_node_events"]:
        problems.append(f"the stitched timeline does not show each node converged once: "
                        f"{timeline['nodes']} duplicates {timeline['duplicate_node_events']}")
    mismatched = phase_seconds_mismatches(fed["node_texts"], fed["merged"])
    if mismatched:
        problems.append("the gateway's tpu_cc_phase_seconds are not the nodes' sums: "
                        + "; ".join(mismatched[:4]))
    if fed["expo_problems"]:
        problems.append(f"the merged exposition fails lint/expo.py: {fed['expo_problems'][:4]}")
    fleet_nodes = fed["fleetz"].get("nodes") or {}
    if sorted(fleet_nodes) != nodes or any(e.get("stale") for e in fleet_nodes.values()):
        problems.append(f"/fleetz does not list both nodes fresh: {fleet_nodes}")
    rows = {line.split()[0]: line.split() for line in fed["status_text"].splitlines()
            if line.split() and line.split()[0] in nodes}
    if fed["status_rc"] != 0 or sorted(rows) != nodes or any(
            row[2:4] != [MODE_ON, MODE_ON] for row in rows.values()):
        problems.append(f"ctl status does not list both nodes on: {fed['status_text']!r}")
    return problems


def check_federated_pool(torch, smi_line: str, smoke_k1: int) -> dict:
    """Phase 18: ``federated_pool`` with K1's matmul smoke on the card as
    each node's verify smoke. Every requirement of ``federated_problems``
    must hold, each node must be ready within the per-node budget, and each
    smoke must make ``smoke_k1`` K1 launches, all on ``sm90``. Returns the
    smokes' launch counts."""
    import pathlib
    import shutil

    from tpu_cc_manager_torch.smoke.runner import run_workload_subprocess

    def smoke(workload: str) -> dict:
        return run_workload_subprocess(workload, timeout_s=300, extra_args=["--kernel", "cuda"])

    t0 = time.perf_counter()
    directory = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_federation"
    shutil.rmtree(directory, ignore_errors=True)
    fed = federated_pool(smoke, directory)
    problems = federated_problems(fed)
    if "error" in fed:
        fail(f"federated flip: {fed['error']}")
    say(f"federated flip: regions {','.join(FED_REGIONS)}, one fake HGX node each, flipped to "
        f"on through ctl.cmd_rollout, failure budget {FED_BUDGET}: pool wall "
        f"{fed['wall_s']:.3f} s; {FED_KILL_REGION} shard killed at {FED_KILL_POINT} "
        f"{fed['killed_s']:.3f} s in, after {fed['converged_before_kill']}; takeover gap "
        f"{fed['takeover_gap_s']:.3f} s (the killed command's exit to the resumed shard); "
        f"{smi_line}")
    say(f"federated flip: ctl rollout --resume: {json.dumps(fed['summary'])}")
    say(f"federated flip: parent record {json.dumps(fed['parent'])}")
    launches = node_smokes("federated flip", fed, smoke_k1, problems)
    timeline = fed["timeline"]
    say(f"federated flip: stitched flight torn lines {fed['torn_lines']}, generations "
        f"{timeline['generations']}, resumes {timeline['resumes']}, node outcomes "
        f"{json.dumps({n: e['outcome'] for n, e in timeline['nodes'].items()})}; fenced patch "
        f"refused={fed['fenced']}, tpu_cc_rollout_fenced_writes_total {fed['fenced_writes']}")
    say(f"federated flip: fleet gateway sweep {fed['sweep_ms']:.3f} ms over "
        f"{len(fed['nodes'])} agents; /fleetz fleet {json.dumps(fed['fleetz'].get('fleet'))}; "
        f"merged exposition {len(fed['merged'])} bytes, lint/expo.py problems "
        f"{len(fed['expo_problems'])}")
    for line in fed["status_text"].splitlines():
        say(f"federated flip: ctl status: {line}")
    say(f"federated flip: phase wall {time.perf_counter() - t0:.3f} s")
    if problems:
        fail("federated flip: " + "; ".join(problems))
    shutil.rmtree(directory, ignore_errors=True)
    return launches



def smoke_results_in(log: str) -> list[dict]:
    """The verify smokes' results an agent logged (``smoke workload ...
    passed: {...}`` or ``warmup smoke ... passed: {...}``), from its text
    or JSON log lines."""
    import ast

    results = []
    for line in log.splitlines():
        try:
            message = json.loads(line).get("message", "")
        except (json.JSONDecodeError, AttributeError):
            message = line
        if " passed: {" in message and "smoke" in message:
            results.append(ast.literal_eval(message.split(" passed: ", 1)[1]))
    return results


def fake_ops_in(log: str) -> list[str]:
    """The fake backend's logged operations (``fake backend: <op>``) in an
    agent's text or JSON log lines, oldest first."""
    ops = []
    for line in log.splitlines():
        try:
            message = json.loads(line).get("message", "")
        except (json.JSONDecodeError, AttributeError):
            message = line
        if "fake backend: " in message:
            ops.append(message.split("fake backend: ", 1)[1].split()[0])
    return ops


def make_writable(root) -> None:
    """Undo ``read_only`` under ``root`` so it can be removed."""
    import os

    for dirpath, _, files in os.walk(root):
        os.chmod(dirpath, 0o755)
        for name in files:
            os.chmod(os.path.join(dirpath, name), 0o644)


def prebuild_image(image, dockerfile: str) -> dict:
    """Phase 19 (a): the image's build step on this machine. The package is
    copied where the image puts it (``image/<app>``), the Dockerfile's
    ``python -m tpu_cc_manager_torch.ops._build --dir DIR`` runs against
    that copy, and ``DIR`` is made read-only (0555). Returns the paths, the
    wall and nvcc's seconds per library."""
    import os
    import pathlib
    import shutil

    from tpu_cc_manager_torch import deploy

    repo = pathlib.Path(__file__).resolve().parent
    app_dir = os.path.dirname(deploy.package_dir(dockerfile))
    app = image / app_dir.lstrip("/")
    shutil.copytree(repo / "tpu_cc_manager_torch", app / "tpu_cc_manager_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    prebuilt = pathlib.Path(deploy.host_path(deploy.prebuild_dir(dockerfile), [], image,
                                             app_dir, app))
    command = deploy.prebuild_command(dockerfile)
    command = [sys.executable, *command[1:command.index("--dir") + 1], str(prebuilt)]
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TPU_CC_CACHE_DIR")}
    env["PYTHONPATH"] = str(app)
    t0 = time.perf_counter()
    proc = subprocess.run(command, cwd=str(app), env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"image build step {command}: rc {proc.returncode}: {proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    for path in [prebuilt, *prebuilt.iterdir()]:
        path.chmod(0o555)
    return {"app": app, "prebuilt": prebuilt, "command": command, "wall_s": wall,
            "seconds": summary["seconds"], "libraries": sorted(p.name for p in
                                                               prebuilt.glob("*.so"))}


def daemonset_problems(run: dict, smoke_k1: int, cards: int) -> list[str]:
    """What phase 19 (b) requires of the manifest-started agent's flip on a
    node of ``cards`` cards."""
    problems = []
    if not run["ready"]:
        problems.append(f"no flip to on in {AGENT_FLIP_TIMEOUT_S} s")
    elif run["drain_to_ready_s"] >= AGENT_BUDGET_S:
        problems.append(f"drain->ready {run['drain_to_ready_s']:.3f} s is over the "
                        f"{AGENT_BUDGET_S:g} s budget")
    if run["healthz"] != 200:
        problems.append(f"the liveness probe's /healthz answered {run['healthz']}")
    if len(run["smokes"]) != 1:
        problems.append(f"{len(run['smokes'])} verify smokes logged, want 1")
    for res in run["smokes"]:
        by_variant = res.get("kernel_launches_by_variant", {}).get("K1", {})
        if not res.get("ok") or by_variant.get("sm90") != smoke_k1 or by_variant.get("simt"):
            problems.append(f"the verify smoke was not ok with {smoke_k1} sm90 K1 launches: "
                            f"ok={res.get('ok')} K1 {by_variant}")
        if tiling_problem(res):
            problems.append(f"the verify smoke: {tiling_problem(res)}")
        if res.get("backend") != "cuda" or res.get("kernel") != "cuda" or \
                res.get("devices") != cards:
            problems.append(f"the verify smoke ran {res.get('kernel')} on "
                            f"{res.get('devices')} {res.get('backend')} device(s), not K1 on "
                            f"the {cards} card(s)")
    if run["built"]:
        problems.append(f"libraries were written outside the prebuilt directory: "
                        f"{run['built']}")
    if run["prebuilt_after"] != run["prebuilt_before"]:
        problems.append("the prebuilt directory changed during the flip")
    ops = run["fake_ops"]
    if ops.count("set_ready") != 1 or "attest" not in ops or \
            ops.index("attest") > ops.index("set_ready"):
        problems.append(f"the fake's log lines do not show the ready state set once after "
                        f"the attestation: {ops}")
    if run["sigterm_rc"] != 0:
        problems.append(f"SIGTERM gave exit {run['sigterm_rc']}")
    return problems


def daemonset_fake_flip(image, app, smoke_k1: int, cards: int,
                        extra_env: dict | None = None) -> dict:
    """Phase 19 (b): ``python -m tpu_cc_manager_torch`` started as its
    container starts it (``deploy.container_launch``: the image's
    entrypoint and env, the manifest's env, each hostPath under
    ``image/host``, ``TPU_CC_CACHE_DIR`` an empty writable directory there)
    against the mock apiserver, with only ``GPU_CC_BACKEND=fake`` and the
    metrics port changed (a free one: the manifest's fixed port is a
    deployment setting, not what the phase proves); ``extra_env`` is for a
    run on the CPU. One flip to on."""
    import pathlib
    import signal
    import urllib.request

    from tpu_cc_manager_torch import deploy
    from tpu_cc_manager_torch.ccmanager import localrig
    from tpu_cc_manager_torch.labels import (
        CC_MODE_LABEL,
        CC_MODE_STATE_LABEL,
        CC_READY_STATE_LABEL,
    )
    from tpu_cc_manager_torch.utils.launch import free_port

    host = image / "host"
    launch = deploy.container_launch(host, app, localrig.NODE)
    cache = pathlib.Path(launch["env"]["TPU_CC_CACHE_DIR"])
    cache.mkdir(parents=True, exist_ok=True)
    prebuilt = app / "build" / "torch_kernels"

    def listing() -> dict:
        return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in prebuilt.iterdir()}

    port = free_port()
    run = {"prebuilt_before": listing(), "launch": launch, "port": port}
    with localrig.LocalRig(str(image / "rig")) as rig:
        agent = rig.start_container(launch, env={"GPU_CC_BACKEND": "fake",
                                                 "CC_METRICS_PORT": str(port),
                                                 **(extra_env or {})})
        # The host is not CC capable, so the agent first applies its default, off.
        if not rig.await_labels({CC_MODE_STATE_LABEL: "off"}, 60):
            fail(f"daemonset agent: no initial reconcile: {rig.log_of(agent)[-3000:]}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                run["healthz"] = r.status
        except OSError as e:
            run["healthz"] = str(e)
        t0 = time.perf_counter()
        rig.set_label(CC_MODE_LABEL, "on")
        run["ready"] = rig.await_labels({CC_MODE_STATE_LABEL: "on",
                                         CC_READY_STATE_LABEL: "true"}, AGENT_FLIP_TIMEOUT_S)
        run["drain_to_ready_s"] = time.perf_counter() - t0
        run["phases"], _ = localrig.await_phases(port, "on", AGENT_PHASES, 30)
        agent.send_signal(signal.SIGTERM)
        try:
            run["sigterm_rc"] = agent.wait(timeout=30)
        except subprocess.TimeoutExpired:
            run["sigterm_rc"] = None
        run["log"] = rig.log_of(agent)
    run["smokes"] = smoke_results_in(run["log"])
    run["fake_ops"] = fake_ops_in(run["log"])
    run["built"] = sorted(str(p) for p in host.rglob("*.so"))
    run["prebuilt_after"] = listing()
    run["problems"] = daemonset_problems(run, smoke_k1, cards)
    return run


class GuardedNvml(FlipNvml):
    """Phase 15's NVML, with the CC ready state's setter refused and
    recorded: phase 19 never sets the real card's ready state. With
    ``standin_report`` each GPU answers the attestation calls with a
    stand-in SPDM report bound to the challenge, unsigned, and no
    certificate chain (the card, CC off, has none to give), so that a quote
    reaches the verifier, which must refuse it."""

    def __init__(self, *args, standin_report: bool = False) -> None:
        super().__init__(*args)
        self.set_calls = []
        self.standin_report = standin_report

    def set_gpus_ready_state(self, state: int) -> None:
        from tpu_cc_manager_torch.gpudev.contract import GpuError

        self.set_calls.append(state)
        raise GpuError("chip_smoke never sets the card's CC ready state")

    def attestation_report(self, handle, nonce: bytes) -> bytes:
        from tpu_cc_manager_torch.gpudev import attestation

        if not self.standin_report:
            return self.real.attestation_report(handle, nonce)
        record = b"stand-in measurement block"
        request = bytes([0x11, attestation.SPDM_GET_MEASUREMENTS, 0, 0]) + nonce + b"\0"
        response = (bytes([0x11, attestation.SPDM_MEASUREMENTS, 0, 0, 1])
                    + len(record).to_bytes(3, "little") + record + bytes(32)
                    + (0).to_bytes(2, "little") + bytes(attestation.SIGNATURE_LEN))
        return request + response

    def attestation_cert_chain(self, handle) -> bytes:
        return b"" if self.standin_report else self.real.attestation_cert_chain(handle)


def daemonset_h100_flip(torch, directory, standin_report: bool = False) -> dict:
    """Phase 19 (c): the manifest's backend, ``h100``, over phase 15's
    stand-ins (``gpudev/standin_admin.py``, a stand-in sysfs tree where the
    machine has no PCI bus, NVML's CC state following the stand-in), with
    the agent (``CCManager.watch_and_apply`` on a thread, the manager's own
    verifier, its spans in a trace file) configured from the manifest's
    smoke env. The flip to on must fail closed at the attestation (NVML
    refuses the report with the card's CC off; with ``standin_report`` the
    verifier refuses ``GuardedNvml``'s stand-in report), the node labelled
    failed with its reason and the agent alive, and the card's ready state
    unchanged with no set call. Returns what the phase checks, the trace
    file's spans among it."""
    import threading

    from tpu_cc_manager_torch import deploy
    from tpu_cc_manager_torch.ccmanager.manager import CCManager
    from tpu_cc_manager_torch.ccmanager.node import NodeBackend
    from tpu_cc_manager_torch.drain.sim import add_drainable_node
    from tpu_cc_manager_torch.gpudev import pci
    from tpu_cc_manager_torch.gpudev.nvml import Nvml, mode_from_state
    from tpu_cc_manager_torch.kubeclient.api import node_labels
    from tpu_cc_manager_torch.kubeclient.fake import FakeKube
    from tpu_cc_manager_torch.labels import (
        CC_FAILED_REASON_LABEL,
        CC_MODE_LABEL,
        CC_MODE_STATE_LABEL,
        MODE_OFF,
        STATE_FAILED,
    )
    from tpu_cc_manager_torch.obs.journal import Journal
    from tpu_cc_manager_torch.smoke.runner import run_workload_subprocess
    from tpu_cc_manager_torch.utils.metrics import MetricsRegistry
    from tpu_cc_manager_torch.utils.poll import poll_until

    env = deploy.env(deploy.MANIFEST.read_text())
    found = pci.scan("/sys")
    by_bdf = pci.torch_index_by_bdf()
    torch_uuid = {bdf: f"GPU-{torch.cuda.get_device_properties(i).uuid}"
                  for bdf, i in by_bdf.items()}
    with Nvml() as nvml:
        start = nvml_view(nvml)
    gpu, admin_dir = standin_h100(torch, directory, mode_from_state(start["state"],
                                                                    start["settings"]),
                                  by_bdf, torch_uuid,
                                  any(f.kind == "nvswitch" for f in found),
                                  pci.pci_bus_present("/sys"))
    gpu.nvml = GuardedNvml(str(admin_dir), torch_uuid, standin_report=standin_report)
    trace = directory / "trace.jsonl"
    smokes = []

    def smoke(workload: str) -> dict:
        smokes.append(workload)
        return run_workload_subprocess(workload, timeout_s=300)

    kube = FakeKube()
    add_drainable_node(kube, AGENT_NODE, AGENT_NS)
    registry = MetricsRegistry()
    agent = CCManager(
        api=kube, backend=NodeBackend(gpu), node_name=AGENT_NODE, default_mode=MODE_OFF,
        operator_namespace=env["OPERATOR_NAMESPACE"], evict_components=True,
        eviction_poll_interval_s=0.02, smoke_workload=env["CC_SMOKE_WORKLOAD"],
        smoke_runner=smoke, metrics=registry, journal=Journal(trace_file=str(trace)),
        watch_timeout_s=1, reconnect_delay_s=0.0,
        readiness_file=str(directory / "ready"), state_dir=str(directory / "state"))
    stop = threading.Event()
    thread = threading.Thread(target=agent.watch_and_apply, args=(stop,), daemon=True,
                              name="agent-h100")
    thread.start()

    def labels() -> dict:
        return node_labels(kube.get_node(AGENT_NODE))

    settled = poll_until(lambda: labels().get(CC_MODE_STATE_LABEL) == MODE_OFF, 60, 0.05)
    t0 = time.perf_counter()
    kube.patch_node_labels(AGENT_NODE, {CC_MODE_LABEL: "on"})
    failed = poll_until(lambda: labels().get(CC_MODE_STATE_LABEL) == STATE_FAILED, 120, 0.05)
    wall = time.perf_counter() - t0
    alive = thread.is_alive()
    stop.set()
    thread.join(timeout=10)
    with Nvml() as nvml:
        end = nvml_view(nvml)
    last = registry.last()
    return {"settled": settled, "failed": failed, "wall_s": wall, "alive": alive,
            "labels": labels(), "reason": labels().get(CC_FAILED_REASON_LABEL),
            "failed_phases": [p.name for p in last.phases if not p.ok] if last else [],
            "phase_s": {p.name: round(p.seconds, 6) for p in last.phases} if last else {},
            "smokes": smokes, "ready_before": start["ready"], "ready_after": end["ready"],
            "state_before": start["state"], "state_after": end["state"],
            "set_calls": gpu.nvml.set_calls,
            "ops": [op for op, _ in gpu.op_log], "gpus": len(by_bdf),
            "spans": [json.loads(line) for line in trace.read_text().splitlines()]}


def h100_span_problems(h100: dict, standin_report: bool) -> list[str]:
    """Phase 19 (c)'s spans: under the flip's reconcile trace, one
    ``reset.chip`` per GPU, and one ``attest.verify`` with problems when a
    quote reached the verifier (none when NVML refused the report)."""
    reconciles = [s for s in h100["spans"] if s["name"] == "reconcile"
                  and s["attributes"].get("mode") == "on"]
    if len(reconciles) != 1:
        return [f"{len(reconciles)} reconciles to on in the trace file, want 1"]
    in_trace = [s for s in h100["spans"] if s["trace_id"] == reconciles[0]["trace_id"]]
    problems = []
    chips = sorted(s["attributes"]["chip"] for s in in_trace if s["name"] == "reset.chip")
    if chips != list(range(h100["gpus"])):
        problems.append(f"reset.chip spans for devices {chips}, want one per GPU "
                        f"({h100['gpus']})")
    verify = [s["attributes"].get("problems") for s in in_trace if s["name"] == "attest.verify"]
    if standin_report and (len(verify) != 1 or not verify[0]):
        problems.append(f"attest.verify problems {verify}, want one span with problems >= 1")
    if not standin_report and verify:
        problems.append(f"attest.verify {verify} with no quote to verify")
    return problems


def check_daemonset_agent(torch, smi_line: str, smoke_k1: int) -> dict:
    """Phase 19: the agent as its DaemonSet starts it (see the module
    docstring). Returns the verify smoke's launch counts."""
    import pathlib
    import shutil

    from tpu_cc_manager_torch import deploy

    t0 = time.perf_counter()
    image = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_image"
    if image.exists():
        make_writable(image)
        shutil.rmtree(image)
    dockerfile = deploy.DOCKERFILE.read_text()

    # --- (a) the image's build step ---
    built = prebuild_image(image, dockerfile)
    say(f"daemonset: image build step {' '.join(built['command'][1:])}: nvcc "
        f"{json.dumps({k: round(v, 3) for k, v in built['seconds'].items()})} s, wall "
        f"{built['wall_s']:.3f} s; {built['libraries']} in {built['prebuilt']}, made "
        f"read-only (0555)")
    if len(built["libraries"]) != len(built["seconds"]) or not built["libraries"]:
        fail(f"daemonset: the build step built {built['seconds']} but left "
             f"{built['libraries']}")

    # --- (b) the manifest-started agent over the fake device layer ---
    run = daemonset_fake_flip(image, built["app"], smoke_k1, torch.cuda.device_count())
    counts = {}
    for res in run["smokes"]:
        counts = {**res["kernel_launches"], **flat_variants(res["kernel_launches_by_variant"])}
        say(f"daemonset: verify smoke ok={res['ok']} devices={res['devices']} kernel "
            f"{res.get('kernel')} blocks={res.get('blocks')} K1 sm90={counts.get('K1/sm90')} "
            f"simt={counts.get('K1/simt')}"
            f"; warmup compile {res.get('warmup_compile_s')} s, overlap "
            f"{res.get('warmup_overlap_s')} s, dispatch {res.get('warmup_dispatch_s')} s")
    env = run["launch"]["env"]
    say(f"daemonset: {' '.join(run['launch']['cmd'])} with the manifest's env "
        f"(GPU_CC_BACKEND=fake, CC_METRICS_PORT={run['port']}; "
        f"TPU_CC_CACHE_DIR={env['TPU_CC_CACHE_DIR']}): drain->ready "
        f"{run['drain_to_ready_s']:.3f} s (budget {AGENT_BUDGET_S:g} s; {smi_line}); "
        f"tpu_cc_phase_seconds {json.dumps(run['phases'])}; /healthz {run['healthz']}; "
        f"libraries written outside the prebuilt directory {len(run['built'])}; fake backend "
        f"ops in the agent's log {run['fake_ops']}; SIGTERM exit {run['sigterm_rc']}")
    if run["problems"]:
        fail("daemonset agent: " + "; ".join(run["problems"]) + f": {run['log'][-3000:]}")

    # --- (c) the manifest's h100 backend over the stand-ins: fails closed, once
    # at NVML's refusal and once at the verifier's ---
    for standin_report in (False, True):
        tag = "h100, stand-in report" if standin_report else "h100"
        h100 = daemonset_h100_flip(torch, image / "h100", standin_report)
        spans = [(s["name"], s["attributes"].get("chip", s["attributes"].get("problems")))
                 for s in h100["spans"] if s["name"] in ("reset.chip", "attest.verify")]
        say(f"daemonset [{tag}]: flip -> on failed={h100['failed']} in {h100['wall_s']:.3f} s "
            f"at {h100['failed_phases']} (phases {json.dumps(h100['phase_s'])}), reason "
            f"{h100['reason']!r}, agent alive {h100['alive']}; NVML ready state before "
            f"{h100['ready_before']}, after {h100['ready_after']}; set calls "
            f"{h100['set_calls']}; backend ops {h100['ops']}; device spans (chip or problems) "
            f"{spans}")
        problems = h100_span_problems(h100, standin_report)
        if not (h100["settled"] and h100["failed"] and h100["alive"]):
            problems.append(f"the flip did not fail with the agent alive: {h100['labels']}")
        if h100["failed_phases"] != ["attest"] or h100["smokes"]:
            problems.append(f"the flip failed at {h100['failed_phases']}, not at its "
                            f"attestation before the smoke ({h100['smokes']})")
        if not h100["reason"]:
            problems.append("the failed node carries no reason")
        if h100["ready_after"] != h100["ready_before"] or h100["state_after"] != \
                h100["state_before"]:
            problems.append("the card's CC ready state or CC state changed")
        if h100["set_calls"] or "set_ready" in h100["ops"]:
            problems.append("the ready state was set without a verified quote")
        if problems:
            fail(f"daemonset [{tag}]: " + "; ".join(problems))
    say(f"daemonset: phase wall {time.perf_counter() - t0:.3f} s")
    make_writable(image)
    shutil.rmtree(image, ignore_errors=True)
    return counts


def job_through_flip(workdir, device: str = "cuda", size: str = "llama3_2_1b",
                     batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                     until: int = TRAIN_STEPS, hold_at: int = JOB_HOLD_AT,
                     reference: list[float] | None = None,
                     agent_env: dict | None = None) -> dict:
    """Phase 20: a training job rides through a CC flip beside the agent
    (``ccmanager/localrig.py``). Against the mock apiserver: the job
    (``localrig job``) trains to ``hold_at`` and holds; the sidecar
    ``python -m tpu_cc_manager_torch.ctl drain-subscribe`` registers with
    ``localrig request-checkpoint`` as its ``--on-drain`` command and a
    resumed job (``--resume``) as its ``--on-resume``; the agent CLI (the fake
    device layer, its matmul verify smoke, ``CC_DRAIN_ACK_TIMEOUT_S`` and
    ``CC_TRACE_FILE`` set) flips the node to on. Without ``reference`` an
    uninterrupted job to ``until`` runs first and its losses are the
    reference. Returns the jobs' events, the agent's spans, phase seconds and
    log, and the walls."""
    import pathlib
    import shutil
    import signal

    from tpu_cc_manager_torch.ccmanager import localrig
    from tpu_cc_manager_torch.drain.handshake import ACTIVE, subscriber_label
    from tpu_cc_manager_torch.labels import (
        CC_MODE_LABEL,
        CC_MODE_STATE_LABEL,
        CC_READY_STATE_LABEL,
    )
    from tpu_cc_manager_torch.utils.launch import free_port
    from tpu_cc_manager_torch.utils.poll import poll_until

    workdir = pathlib.Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    job_args = ["--size", size, "--batch", str(batch), "--seq", str(seq), "--until", str(until),
                "--device", device]
    job_env = {"OMP_NUM_THREADS": "1"} if device == "cpu" else {}
    run = {"reference_run": reference is None}
    trace = workdir / "trace.jsonl"
    port = free_port()
    job_dir = workdir / "job"
    with localrig.LocalRig(str(workdir / "rig")) as rig:
        def events_of(job_dir, proc, want: str) -> list[dict]:
            """``job_dir``'s events once one is ``want``; fails naming
            ``proc``'s log if it exits non-zero first or none comes."""
            if not poll_until(lambda: proc.poll() not in (None, 0) or any(
                    e["event"] == want for e in localrig.job_events(str(job_dir))),
                    JOB_TIMEOUT_S, 0.1) or proc.poll() not in (None, 0):
                fail(f"job: no {want!r} event from {job_dir}: rc {proc.poll()}: "
                     f"{rig.log_of(proc)[-3000:]}")
            return localrig.job_events(str(job_dir))

        if reference is None:
            ref_dir = workdir / "reference"
            events = events_of(ref_dir, rig.start_job(str(ref_dir), job_args, env=job_env),
                               "done")
            run["reference_events"] = events
            reference = [e["loss"] for e in events if e["event"] == "step"]
            shutil.rmtree(ref_dir / "ckpt", ignore_errors=True)
        run["reference"] = reference
        job = rig.start_job(str(job_dir), [*job_args, "--hold-at", str(hold_at)], env=job_env)
        sidecar = rig.start_ctl(
            ["drain-subscribe", "--node", localrig.NODE, "--job", JOB_SUBSCRIBER,
             "--on-drain", localrig.request_checkpoint_cmd(str(job_dir)),
             "--on-resume", localrig.job_cmd(str(job_dir), [*job_args, "--resume"]),
             "--poll-interval", str(JOB_SUB_POLL_S)], env=job_env)
        agent = rig.start_agent(
            ["--gpu-backend", "fake", "--smoke-workload", "matmul"], metrics_port=port,
            env={"CC_DRAIN_ACK_TIMEOUT_S": str(JOB_ACK_TIMEOUT_S), "CC_TRACE_FILE": str(trace),
                 **(agent_env or {})})
        # The host is not CC capable, so the agent first applies its default, off.
        if not rig.await_labels({CC_MODE_STATE_LABEL: "off"}, 60):
            fail(f"job: the agent made no initial reconcile: {rig.log_of(agent)[-3000:]}")
        if not rig.await_labels({subscriber_label(JOB_SUBSCRIBER): ACTIVE}, 60):
            fail(f"job: the sidecar did not register: {rig.log_of(sidecar)[-3000:]}")
        events_of(job_dir, job, "held")
        t0 = time.perf_counter()
        rig.set_label(CC_MODE_LABEL, "on")
        run["ready"] = rig.await_labels({CC_MODE_STATE_LABEL: "on",
                                         CC_READY_STATE_LABEL: "true"}, AGENT_FLIP_TIMEOUT_S)
        run["drain_to_ready_s"] = time.perf_counter() - t0
        run["phases"], _ = localrig.await_phases(port, "on", AGENT_PHASES, 30)
        if run["ready"]:
            events_of(job_dir, sidecar, "done")
        run["events"] = localrig.job_events(str(job_dir))
        run["job_rc"] = job.poll()
        run["sidecar_alive"] = sidecar.poll() is None
        agent.send_signal(signal.SIGTERM)
        try:
            run["sigterm_rc"] = agent.wait(timeout=30)
        except subprocess.TimeoutExpired:
            run["sigterm_rc"] = None
        run["log"] = rig.log_of(agent)
        run["sidecar_log"] = rig.log_of(sidecar)
    run["spans"] = ([json.loads(line) for line in trace.read_text().splitlines()]
                    if trace.exists() else [])
    run["smokes"] = smoke_results_in(run["log"])
    shutil.rmtree(workdir, ignore_errors=True)
    return run


def job_steps(run: dict) -> tuple[list[dict], list[dict]]:
    """The step events of the first job and of the resumed one."""
    first_pid = next(e["pid"] for e in run["events"] if e["event"] == "held")
    steps = [e for e in run["events"] if e["event"] == "step"]
    return ([e for e in steps if e["pid"] == first_pid],
            [e for e in steps if e["pid"] != first_pid])


def job_flip_problems(run: dict, hold_at: int, until: int, n_layers: int, smoke_k1: int,
                      cards: int, device: str = "cuda") -> list[str]:
    """What phase 20 requires of a ``job_through_flip`` run: the checkpoint
    before any component pause, the job gone before the first reset, the
    node on and ready within the budget, one verify smoke (K1 on every card
    with ``smoke_k1`` sm90 launches on the card), the resumed losses equal
    to the reference's at every printed digit, each step's K2/K3/K4 once
    per layer on their sm90 kernels (none on the CPU, where the wrappers run
    their plain versions), and ``attest.verify`` under the reconcile's
    trace. Returns the problems found."""
    problems = []
    events = run["events"]
    saved = [e for e in events if e["event"] == "checkpoint"]
    exited = [e for e in events if e["event"] == "exited"]
    restored = [e for e in events if e["event"] == "restored"]
    if [e["step"] for e in saved] != [hold_at] or [e["step"] for e in restored] != [hold_at]:
        problems.append(f"checkpoints {[e['step'] for e in saved]} and restores "
                        f"{[e['step'] for e in restored]}, want one of each at step {hold_at}")
    if [e["saved"] for e in exited] != [True]:
        problems.append(f"the checkpoint request saw {exited}, want one exit after a save")
    first, resumed = job_steps(run) if any(e["event"] == "held" for e in events) else ([], [])
    printed = [round(x, 6) for x in run["reference"]]
    got = [round(e["loss"], 6) for e in first + resumed]
    if [e["step"] for e in first + resumed] != list(range(1, until + 1)) or got != printed:
        problems.append(f"the job's losses {got} (steps "
                        f"{[e['step'] for e in first + resumed]}) are not the uninterrupted "
                        f"run's {printed}")
    n = n_layers if device == "cuda" else 0
    want = {"K1": 0, "K2": n, "K3": n, "K4": n, "K1/sm90": 0, "K1/simt": 0, "K2/sm90": n,
            "K2/simt": 0, "K3/sm90": n, "K3/simt": 0, "K4/sm90": n, "K4/simt": 0}
    wrong = [e["step"] for e in first + resumed if e["launches"] != want]
    if wrong:
        problems.append(f"steps {wrong} did not launch {want}")
    spans = run["spans"]
    reconciles = [s for s in spans if s["name"] == "reconcile"
                  and s["attributes"].get("mode") == "on"]
    if len(reconciles) != 1:
        problems.append(f"{len(reconciles)} reconciles to on in the trace file, want 1")
    else:
        in_trace = [s for s in spans if s["trace_id"] == reconciles[0]["trace_id"]]
        starts = {name: min((s["start_ts"] for s in in_trace if s["name"] == name), default=None)
                  for name in ("drain.pause_components", "reset")}
        if None in starts.values() or not saved or not exited:
            problems.append(f"no pause or reset span, checkpoint or exit to order: {starts}")
        else:
            if not saved[0]["t"] < starts["drain.pause_components"]:
                problems.append("the checkpoint did not land before the components' pause")
            if not exited[0]["t"] < starts["reset"]:
                problems.append("the job had not exited before the backend's first reset")
        if not any(s["name"] == "attest.verify" for s in in_trace):
            problems.append("no attest.verify span under the reconcile's trace id")
        if not any(s["name"] == "drain.handshake" for s in in_trace):
            problems.append("no drain.handshake span: the agent did not wait for the job")
    if not run["ready"]:
        problems.append(f"no flip to on in {AGENT_FLIP_TIMEOUT_S} s")
    elif run["drain_to_ready_s"] >= AGENT_BUDGET_S:
        problems.append(f"drain->ready {run['drain_to_ready_s']:.3f} s is over the "
                        f"{AGENT_BUDGET_S:g} s budget")
    if len(run["smokes"]) != 1:
        problems.append(f"{len(run['smokes'])} verify smokes logged, want 1")
    for res in run["smokes"]:
        k1 = res.get("kernel_launches_by_variant", {}).get("K1", {})
        want_k1 = smoke_k1 if device == "cuda" else 0
        if not res.get("ok") or k1.get("sm90", 0) != want_k1 or k1.get("simt", 0) or \
                res.get("backend") != device or res.get("devices") != cards:
            problems.append(f"the verify smoke was not ok with {want_k1} sm90 K1 launches on "
                            f"{cards} {device} device(s): ok={res.get('ok')} K1 {k1} on "
                            f"{res.get('devices')} {res.get('backend')}")
        if tiling_problem(res):
            problems.append(f"the verify smoke: {tiling_problem(res)}")
    if not run["sidecar_alive"] or run["sigterm_rc"] != 0:
        problems.append(f"the sidecar alive {run['sidecar_alive']}, the agent's SIGTERM exit "
                        f"{run['sigterm_rc']}")
    return problems


def run_bench(module: str, args: list[str], env: dict) -> tuple[dict, int, float]:
    """``python -m tpu_cc_manager_torch.bench.<module> <args>`` from the
    repository root: its one JSON line, exit code and wall seconds."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", f"tpu_cc_manager_torch.bench.{module}", *args],
            capture_output=True, text=True, timeout=BENCH_TIMEOUT_S, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        fail(f"bench {module} {' '.join(args)} ran past {BENCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if len(lines) != 1:
        fail(f"bench {module} {' '.join(args)} printed {len(lines)} JSON lines, not one "
             f"(rc={proc.returncode}): {proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    return json.loads(lines[0]), proc.returncode, wall


def bench_smokes(tag: str, smokes: list[dict], smoke_k1: int, problems: list) -> dict:
    """Hold each of a bench's verify smokes (its ``smoke_kernels``) to the
    card, phase 5's K1 count, all on ``sm90``, at the default tiling;
    append what fails to ``problems``. Returns their launches, summed."""
    launches = dict.fromkeys(COUNT_KEYS, 0)
    for i, res in enumerate(smokes):
        counts = {**dict.fromkeys(COUNT_KEYS, 0), **(res.get("kernel_launches") or {}),
                  **flat_variants(res.get("kernel_launches_by_variant") or {})}
        say(f"{tag} smoke {i}: backend={res.get('backend')} kernel={res.get('kernel')} "
            f"blocks={res.get('blocks')} size={res.get('size')} devices={res.get('devices')} "
            f"K1 sm90={counts['K1/sm90']} simt={counts['K1/simt']}")
        if res.get("backend") != "cuda":
            problems.append(f"{tag} smoke {i} ran on {res.get('backend')}, not the card")
        if counts["K1/sm90"] != smoke_k1 or counts["K1"] != smoke_k1:
            problems.append(f"{tag} smoke {i} made K1 {counts['K1']} (sm90 "
                            f"{counts['K1/sm90']}), want {smoke_k1} on sm90")
        if tiling_problem(res):
            problems.append(f"{tag} smoke {i}: {tiling_problem(res)}")
        launches = {k: launches[k] + counts[k] for k in COUNT_KEYS}
    return launches


def check_node_bench(torch, smi_line: str, smoke_k1: int) -> dict:
    """Phase 21: the node bench on the card (``tpu_cc_manager_torch/bench``,
    the port of the repository's ``bench.py``, ``bench_ab.py`` and
    ``hack/smoke_cache_bench.py``), each a process from the repository root.
    (a) ``bench`` with ``CC_BENCH_REALISTIC_RUNS`` = ``BENCH_REALISTIC_RUNS``:
    ok, under the 90 s target, ``smoke_backend`` cuda, the cold smoke's
    fresh build directory holding at least one library and the warm one
    having built none; (b) ``bench --spare``: ok, the spare's effective flip
    under its pool-mate's full path; (c) ``bench_ab --workloads matmul``
    at ``AB_REPS`` x ``AB_CYCLES``: both arms measured on the card. Every
    verify smoke of the three must report phase 5's K1 count, all ``sm90``,
    at the default tiling. Returns the smokes' launches, summed."""
    report_memory(torch, "before phase 21")
    env = {**os.environ, "CC_BENCH_REALISTIC_RUNS": str(BENCH_REALISTIC_RUNS)}
    problems = []
    launches = dict.fromkeys(COUNT_KEYS, 0)

    def add(counts: dict) -> None:
        launches.update({k: launches[k] + counts[k] for k in COUNT_KEYS})

    res, rc, wall = run_bench("bench", [], env)
    cache = res.get("smoke_cache") or {}
    say(f"node bench (a) {smi_line}: rc={rc} ok={res.get('ok')} drain->ready "
        f"{res.get('value')} s (target 90 s, under_target={res.get('under_target')}) "
        f"wall_seconds={res.get('wall_seconds')} sum_phase_seconds="
        f"{res.get('sum_phase_seconds')} overlap_saved_s={res.get('overlap_saved_s')} "
        f"smoke_backend={res.get('smoke_backend')} chip_generation="
        f"{res.get('chip_generation')} smoke_tflops={res.get('smoke_tflops')} smoke_mfu="
        f"{res.get('smoke_mfu')}; the command {wall:.1f} s")
    say(f"node bench (a) phases {json.dumps(res.get('phases'))} smoke_warmup "
        f"{json.dumps(res.get('smoke_warmup'))} control {json.dumps(res.get('control'))} "
        f"handshake {json.dumps(res.get('workload_handshake'))}")
    say(f"node bench (a) phase_histograms {json.dumps(res.get('phase_histograms'))}")
    say(f"node bench (a) cold vs warm smoke: smoke_cold_s={res.get('smoke_cold_s')} "
        f"smoke_warm_s={res.get('smoke_warm_s')} warm_speedup={cache.get('warm_speedup')} "
        f"cache_entries={cache.get('cache_entries')} warm_built={cache.get('warm_built')} "
        f"elsewhere={cache.get('elsewhere')} ok={cache.get('ok')} {cache.get('error', '')}")
    if not (rc == 0 and res.get("ok") and res.get("under_target")
            and res.get("smoke_backend") == "cuda"):
        problems.append(f"bench: rc={rc} {json.dumps(res)[:1500]}")
    if not (cache.get("ok") and (cache.get("cache_entries") or 0) >= 1
            and cache.get("warm_built") == 0 and not cache.get("elsewhere")):
        problems.append(f"cold vs warm smoke: {json.dumps(cache)[:1500]}")
    add(bench_smokes("node bench (a)", (res.get("smoke_kernels") or [])
                     + (cache.get("smokes") or []), smoke_k1, problems))

    spare, rc, wall = run_bench("bench", ["--spare"], env)
    say(f"node bench (b) spare {smi_line}: rc={rc} ok={spare.get('ok')} effective flip "
        f"{spare.get('effective_flip_wall_s')} s against the pool-mate's full path "
        f"{spare.get('full_path_wall_s')} s (bar drain+readmit "
        f"{spare.get('bar_drain_plus_readmit_s')} s) prestage {spare.get('prestage_wall_s')} "
        f"s rollout {spare.get('rollout_wall_s')} s; smoke windows overlapped: "
        f"{spare.get('smoke_windows_overlap')}; the command {wall:.1f} s")
    if not (rc == 0 and spare.get("ok")
            and spare["effective_flip_wall_s"] < spare["full_path_wall_s"]):
        problems.append(f"bench --spare: rc={rc} {json.dumps(spare)[:1500]}")
    add(bench_smokes("node bench (b)", spare.get("smokes") or [], smoke_k1, problems))

    ab, rc, wall = run_bench("bench_ab", ["--workloads", "matmul", "--reps", str(AB_REPS),
                                          "--cycles", str(AB_CYCLES)], env)
    arms = (ab.get("workloads") or {}).get("matmul") or {}
    for mode in ("off", "on"):
        arm = arms.get(mode) or {}
        say(f"node bench (c) A/B matmul CC {mode} {smi_line}: tflops {arm.get('throughput')} "
            f"samples {arm.get('throughput_samples')} mean {arm.get('mean')} +- "
            f"{arm.get('ci95_half_width')} (95% CI) mfu {arm.get('mfu')} backend "
            f"{arm.get('backend')} reps {arm.get('reps')}")
        if arm.get("backend") != "cuda" or arm.get("throughput") is None:
            problems.append(f"A/B arm {mode} was not measured on the card: {json.dumps(arm)}")
    say(f"node bench (c) A/B: rc={rc} ok={ab.get('ok')} loss_pct={arms.get('loss_pct')} +- "
        f"{arms.get('loss_pct_ci95_half_width')} (95%) loss_powered="
        f"{arms.get('loss_powered')} (both arms CC off: the fake device layer; the harness's "
        f"noise floor); the command {wall:.1f} s")
    add(bench_smokes("node bench (c)", ab.get("smoke_kernels") or [], smoke_k1, problems))
    if len(ab.get("smoke_kernels") or []) != 2 * AB_REPS * AB_CYCLES:
        problems.append(f"the A/B ran {len(ab.get('smoke_kernels') or [])} smokes, not "
                        f"{2 * AB_REPS * AB_CYCLES}")
    if problems:
        fail("phase 21, the node bench: " + "; ".join(problems))
    return launches


def check_job_through_flip(torch, smi_line: str, smoke_k1: int,
                           reference: list[float]) -> dict:
    """Phase 20 on the card (see ``job_through_flip``); ``reference`` is
    phase 7's losses. Returns the launch counts of the jobs' steps and of
    the verify smoke."""
    import pathlib

    from tpu_cc_manager_torch.models.llama import LlamaConfig

    t0 = time.perf_counter()
    report_memory(torch, "job through a flip")
    cards = torch.cuda.device_count()
    n_layers = LlamaConfig.llama3_2_1b().n_layers
    workdir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_job"
    run = job_through_flip(workdir, reference=reference,
                           agent_env={"GPU_CC_FAKE_NUM_GPUS": str(cards),
                                      "GPU_CC_FAKE_NUM_SWITCHES": "0"})
    events = run["events"]
    first, resumed = job_steps(run)
    saved = next((e for e in events if e["event"] == "checkpoint"), {})
    restored = next((e for e in events if e["event"] == "restored"), {})
    handshake = [s["seconds"] for s in run["spans"] if s["name"] == "drain.handshake"]
    downtime = resumed[0]["t"] - first[-1]["t"] if first and resumed else None
    say(f"job: Llama-3.2-1B, {n_layers} layers, batch {TRAIN_BATCH}x{TRAIN_SEQ}, held at step "
        f"{JOB_HOLD_AT}; losses before the flip {[round(e['loss'], 6) for e in first]}, "
        f"after {[round(e['loss'], 6) for e in resumed]}; the uninterrupted run's "
        f"({'this phase' if run['reference_run'] else 'phase 7'}) "
        f"{[round(x, 6) for x in run['reference']]}")
    say(f"job: checkpoint {saved.get('bytes')} bytes, save {saved.get('save_s')} s, restore "
        f"{restored.get('restore_s')} s; handshake wait inside drain {handshake} s; "
        f"drain->ready {run['drain_to_ready_s']:.3f} s (budget {AGENT_BUDGET_S:g} s; "
        f"{smi_line}); tpu_cc_phase_seconds {json.dumps(run['phases'])}; the job's downtime "
        f"(its last step before the request to its first after the resume) {downtime} s")
    launches = {}
    for e in first + resumed:
        launches = {k: launches.get(k, 0) + v for k, v in e["launches"].items()}
    for res in run["smokes"]:
        counts = {**res["kernel_launches"], **flat_variants(res["kernel_launches_by_variant"])}
        say(f"job: verify smoke ok={res['ok']} devices={res['devices']} blocks="
            f"{res.get('blocks')} K1 sm90={counts.get('K1/sm90')} simt={counts.get('K1/simt')}")
        launches = {k: launches.get(k, 0) + counts.get(k, 0) for k in launches}
    say(f"job: launches over {len(first) + len(resumed)} steps and the verify smoke "
        f"{launches}")
    problems = job_flip_problems(run, JOB_HOLD_AT, TRAIN_STEPS, n_layers, smoke_k1, cards)
    if problems:
        fail("job through a flip: " + "; ".join(problems) + f": {run['log'][-2000:]} "
             f"{run['sidecar_log'][-2000:]}")
    say(f"job: phase wall {time.perf_counter() - t0:.3f} s")
    return launches


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only-kernels", action="store_true",
                   help="stop after building and checking the kernels (phases 1-4)")
    p.add_argument("--gloo-tp-child", choices=("sound", GLOO_TP_FAULT),
                   help="run as one process of phase 12 (the script starts these)")
    p.add_argument("--gloo-smoke-child", action="store_true",
                   help="run as one process of phase 13 (the script starts these)")
    args = p.parse_args(argv)
    if args.gloo_tp_child:
        return gloo_tp_rank(args.gloo_tp_child == GLOO_TP_FAULT)
    if args.gloo_smoke_child:
        return gloo_smoke_rank()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from tpu_cc_manager_torch import ops
        from tpu_cc_manager_torch.ops import _build
        from tpu_cc_manager_torch.utils import gpu_info
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")

    clock = PhaseClock()
    # --- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not smi_line:
        fail(f"nvidia-smi failed: rc={smi.returncode} {smi.stderr.strip()}")
    say(smi_line)
    kind = torch.cuda.get_device_name(0)
    variant = gpu_info.variant_from_name(kind)
    say(f"device: {kind} (variant {variant}), count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if variant is None:
        fail(f"no published peaks for {kind!r}: cannot state bounds")
    peaks = {
        "bf16": gpu_info.PEAK_BF16_FLOPS[variant],
        "f32": gpu_info.PEAK_F32_FLOPS[variant],
        "bw": gpu_info.PEAK_HBM_BYTES_PER_S[variant],
    }
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32

    clock.lap("phase 1")
    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    say(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s into {_build.build_dir()}")
    simt = {}
    for name in _build.SIGNATURES:
        log = _build.build_log(name)
        for line in log.splitlines():
            # ptxas also warns here when it has to serialize wgmma groups.
            if any(key in line for key in ("registers", "spill", "Compiling entry", "wgmma")):
                say(f"ptxas[{name}]: {line.strip()}")
        simt.update(simt_kernel_report(log))
    # The f32 K1 and the simt K2, K3 and K4: each instance's registers and
    # spills, and each flash instance launched once, its dynamic shared
    # memory (the trace's, less ptxas's static) against the Python count.
    t0 = time.perf_counter()
    launched = simt_flash_launches(torch)
    say(f"simt K2-K4 instances launched once under torch.profiler: {len(launched)} in "
        f"{time.perf_counter() - t0:.1f} s")
    problems = []
    for kernel, r in sorted(simt.items()):
        line = (f"ptxas {kernel}: {r.get('registers')} registers, spill stores "
                f"{r.get('spill_stores')} / loads {r.get('spill_loads')} bytes, {r['smem']} bytes "
                f"of static shared memory")
        if r.get("spill_stores") != 0 or r.get("spill_loads") != 0:
            problems.append(f"{kernel} spills")
        if kernel.startswith(SIMT_FLASH):
            run = launched.get(kernel)
            dynamic = None if run is None or run["trace_smem"] is None else \
                run["trace_smem"] - r["smem"]
            if run is not None:
                line += (f"; launched at D = {run['D']}: {fmt_bytes(dynamic)} of dynamic shared "
                         f"memory (Python count {run['python_count']}), "
                         f"{run['trace_registers']} registers")
            if dynamic != (run or {}).get("python_count"):
                problems.append(f"{kernel}: dynamic shared memory {dynamic} is not the Python "
                                f"count {(run or {}).get('python_count')}")
        say(line)
    from tpu_cc_manager_torch.ops import flash_attention as fa

    for label, count in (("K2", fa.fwd_simt_smem_bytes), ("K3", fa.dq_simt_smem_bytes),
                         ("K4", fa.dkv_simt_smem_bytes)):
        say(f"simt {label} dynamic shared memory a block: " + ", ".join(
            f"{dtype} D = {D}: {count(D, size)} bytes"
            for dtype, size in (("f32", 4), ("bf16", 2)) for D in (64, 72, 128)))
    if len(simt) != SIMT_INSTANCES or problems:
        fail(f"the f32 K1 and simt K2-K4 instances did not all build ({len(simt)} of "
             f"{SIMT_INSTANCES}) without spills at the Python shared memory: {problems}")

    clock.lap("phase 2")
    # --- 3. and 4. kernels against their plain versions ----------------------
    k1 = check_k1(torch, peaks, variant)
    k2 = check_k2(torch, peaks)
    k3, k4 = check_k3_k4(torch, peaks)
    clock.lap("phases 3-4")
    if args.only_kernels:
        say(json.dumps({"kernels_checked": {"K1": k1, "K2": k2, "K3": k3, "K4": k4}}))
        return 0

    # --- 5. matmul smoke, both kernels -----------------------------------------
    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

    # Launches per kernel and path, each path run with the counts at 0.
    paths = {}
    for kernel in ("torch", "cuda"):
        try:
            res = run_workload_subprocess("matmul", timeout_s=300,
                                          extra_args=["--kernel", kernel])
        except SmokeError as e:
            fail(f"matmul smoke --kernel {kernel}: {e}")
        launches = {**res["kernel_launches"], **flat_variants(res["kernel_launches_by_variant"])}
        say(f"matmul smoke kernel={kernel}: ok={res['ok']} size={res['size']} "
            f"blocks={res['blocks']} tflops={res['tflops']} mfu={res['mfu']} "
            f"ident_err={res['ident_err']} rowsum_rel_err={res['rowsum_rel_err']:.3e} "
            f"launches={launches} devices={res['devices']} (visible {res['visible_devices']}) "
            f"per_device={json.dumps(res['per_device'])}")
        if res["backend"] != "cuda":
            fail(f"matmul smoke ran on {res['backend']}, not the card")
        # Either kernel verifies every card.
        check_devices(f"matmul smoke --kernel {kernel}", res, torch.cuda.device_count())
        if kernel == "cuda":
            paths["matmul smoke"] = launches
            if launches["K1"] <= 0 or launches["K1/sm90"] != launches["K1"]:
                fail("matmul smoke --kernel cuda did not launch K1, or not all on its sm90 kernel")
            if tiling_problem(res):
                fail(f"matmul smoke --kernel cuda: {tiling_problem(res)}")
    paths["matmul smoke --cuda-blocks"] = check_cuda_blocks_cli(
        k1["sweep"]["4096x4096x4096"]["rows"][0]["blocks"], paths["matmul smoke"]["K1"])

    clock.lap("phase 5")
    # --- 6. Llama-3-8B inference smoke, full width ----------------------------
    try:
        res = run_workload_subprocess("llama", timeout_s=700,
                                      extra_args=["--size", "llama3-8b"])
    except SmokeError as e:
        fail(f"llama smoke: {e}")
    say("llama smoke: " + json.dumps(
        {k: res.get(k) for k in (
            "model", "params", "batch", "oracle_ok", "transcript_ok",
            "transcript_margin", "flash_kernel_rel_err", "tokens_per_sec", "ms_per_token",
            "prefill_tokens_per_sec", "hbm_bw_util", "mfu", "prefill_mfu",
            "kernel_launches")}))
    say(f"llama smoke: devices={res['devices']} per_device={json.dumps(res['per_device'])}")
    check_devices("llama smoke", res, torch.cuda.device_count())
    llama_one_card = res
    rel = res.get("flash_kernel_rel_err")
    if not (res["ok"] and res["oracle_ok"] and res["transcript_ok"]
            and rel is not None and rel < 5e-2):
        fail(f"llama smoke oracles failed: {res}")
    paths["llama smoke"] = {**res["kernel_launches"],
                            **flat_variants(res["kernel_launches_by_variant"])}
    smoke_k2 = paths["llama smoke"]
    say(f"llama smoke K2 launches by variant: sm90={smoke_k2['K2/sm90']} "
        f"simt={smoke_k2['K2/simt']}")
    if smoke_k2["K2"] <= 0 or smoke_k2["K2/sm90"] != smoke_k2["K2"]:
        fail("the llama smoke's K2 launches did not all go to the sm90 kernel")

    # The same smoke with every cached-decode position shifted by one (the
    # off-by-one the transcript oracle exists for) must fail at full width.
    from tpu_cc_manager_torch.smoke import llama_infer

    faulty = llama_infer.run(size=cut_smoke_size(), cache_position_offset=1)
    say(f"llama smoke ({faulty['model']}), cache_position_offset=1: ok={faulty['ok']} "
        f"transcript_ok={faulty['transcript_ok']} transcript_margin="
        f"{faulty['transcript_margin']} (limit {TRANSCRIPT_LIMIT:g}; clean run "
        f"{res['transcript_margin']})")
    if faulty["ok"] or faulty["transcript_ok"]:
        fail("the Llama-3-8B transcript oracle missed the cache off-by-one")
    del faulty
    torch.cuda.empty_cache()

    from tpu_cc_manager_torch.entry import entry

    forward, example = entry()
    ops.reset_launch_counts()
    logits = forward(*example)
    torch.cuda.synchronize()
    paths["entry"] = {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}
    entry_k2 = paths["entry"]["K2"]
    say(f"entry(): logits {tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())} "
        f"K2 launches={entry_k2} (simt {paths['entry']['K2/simt']}, head dim 16)")
    if tuple(logits.shape) != (2, 16, 256) or not bool(torch.isfinite(logits).all()):
        fail("entry() forward gave a wrong shape or non-finite logits")
    if entry_k2 <= 0 or paths["entry"]["K2/simt"] != entry_k2:
        fail("entry() forward did not launch K2, or not on its simt kernel")
    del logits, forward, example
    torch.cuda.empty_cache()

    clock.lap("phase 6")
    # --- 7. the parallel layer, Llama-3.2-1B training on it ----------------------
    mesh = check_parallel_layer()
    train = train_llama_1b(torch, peaks, mesh)
    paths["1b training"] = train["launches"]

    clock.lap("phase 7")
    # --- 8. ResNet-50 smoke -----------------------------------------------------
    resnet_smoke(torch)
    torch.cuda.empty_cache()

    clock.lap("phase 8")
    # --- 9. checkpoint round trip -------------------------------------------------
    checkpoint_round_trip(torch)
    torch.cuda.empty_cache()

    clock.lap("phase 9")
    # --- 10. ring attention on virtual ranks ---------------------------------------
    check_ring(torch)

    clock.lap("phase 10")
    # --- 11. tensor parallelism on virtual ranks -----------------------------------
    paths.update(check_tp(torch, k2))

    clock.lap("phase 11")
    # --- 12. the tp=2 train step, two processes on this card over gloo -------------
    paths[f"tp={GLOO_TP} train step, {GLOO_TP} processes"] = check_gloo_tp_step(
        torch, train["losses"])

    clock.lap("phase 12")
    # --- 13. the 8B smoke as one tp=2 group, two processes over gloo ---------------
    paths[f"llama smoke tp={GLOO_TP}, {GLOO_TP} processes"] = check_gloo_smoke(torch,
                                                                             llama_one_card)

    clock.lap("phase 13")
    # --- 14. the Hugging Face loader at Llama-3.2-1B width --------------------------
    paths["hf loader 1b forward"] = check_hf_loader(torch)

    clock.lap("phase 14")
    # --- 15. the device layer (gpudev) on the card ---------------------------------
    paths["device layer verify smoke"] = check_device_layer(torch, smi_line)

    clock.lap("phase 15")
    # --- 16. the port's agent on the card ------------------------------------------
    paths["agent verify smoke"] = check_agent(torch, smi_line)

    clock.lap("phase 16")
    # --- 17. a rolling flip of a pool of two nodes, killed and resumed -------------
    paths["rolling pool verify smoke"] = check_rolling_pool(
        torch, smi_line, paths["matmul smoke"]["K1"])

    clock.lap("phase 17")
    # --- 18. a federated flip of two regions through ctl, a shard killed -----------
    paths["federated flip verify smoke"] = check_federated_pool(
        torch, smi_line, paths["matmul smoke"]["K1"])

    clock.lap("phase 18")
    # --- 19. the agent as its DaemonSet starts it ---------------------------------
    paths["daemonset agent verify smoke"] = check_daemonset_agent(
        torch, smi_line, paths["matmul smoke"]["K1"])

    clock.lap("phase 19")
    # --- 20. a training job through a CC flip via the drain handshake ------------
    paths["job through a flip"] = check_job_through_flip(
        torch, smi_line, paths["matmul smoke"]["K1"], train["losses"])

    clock.lap("phase 20")
    # --- 21. the node bench on the card ----------------------------------------
    paths["node bench verify smokes"] = check_node_bench(
        torch, smi_line, paths["matmul smoke"]["K1"])

    clock.lap("phase 21")
    # --- 22. kernel summary -----------------------------------------------------
    def counted(key: str) -> dict:
        by_path = {path: c[key] for path, c in paths.items() if c[key]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    attention = "tpu_cc_manager_torch/csrc/flash_attention.cu"
    # (name, source, TPU kernel, timed shapes); each kernel's launches are
    # counted by the variant that ran at the timed shape.
    table = [
        ("K1 tiled_matmul", "tpu_cc_manager_torch/csrc/matmul.cu",
         "tpu_cc_manager/ops/matmul.py:55", k1["timed"] + k1["simt"]),
        ("K2 flash_forward", attention, "tpu_cc_manager/ops/flash_attention.py:64", k2),
        ("K3 flash_backward_dq", attention, "tpu_cc_manager/ops/flash_attention.py:179", k3),
        ("K4 flash_backward_dkv", attention, "tpu_cc_manager/ops/flash_attention.py:231", k4),
    ]
    kernels = []
    for name, source, replaces, timed in table:
        for t in timed:
            at = f" at {tuple(t['blocks'])}" if "blocks" in t else ""
            kernel = {"name": f"{name} [{t['variant']}] {tuple(t['shape'])}{at}",
                      "route": "cuda", "source": source, "replaces": replaces,
                      **counted(f"{name.split()[0]}/{t['variant']}"), **t}
            # Whether a path launches this variant; the f32 K1 and the simt
            # K3 and K4 are checked against their plain versions but run on
            # no path.
            kernel["on_path"] = kernel["launches"] > 0
            kernels.append(kernel)
    for kernel in kernels:
        if f"{kernel['name'].split()[0]}/{kernel['variant']}" in PATH_VARIANTS \
                and not kernel["on_path"]:
            fail(f"{kernel['name']} was launched no time on the paths driven")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    # --- 23. last line ------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
