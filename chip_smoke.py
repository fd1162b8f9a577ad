"""Smoke test of the PyTorch port (immunostruct_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

``python3 chip_smoke.py --eager-walls DIR ...`` runs none of the phases
below: it times the eager 'mega' forward at B=128 and B=1 and a 'pallas'
and a 'fused' train step with the package of each checkout DIR and with
this one's, each in a fresh process, in the order DIR ..., this, this,
... DIR (``compare_eager``); in this one's, through the kernel ops and
with the wrappers launching directly in turn (``eager_walls``).

The Trainers' steps and the Scorers' forwards in every phase run as
captured CUDA graphs (immunostruct_tpu_torch/utils/capture.py), as a
user's do on the card: a key's first call eager, its second captured, later
calls replayed. Phase 31 holds them to the eager path.

Phases (none catches its own failure; any failure exits non-zero):
  1. require CUDA;
  2. print the card's name and power limit (nvidia-smi);
  3. build the ten Hopper kernel sources with nvcc, one process per source,
     all at once: csrc/egnn_mega_fwd.cu (B1, the EGNN edge forward from raw
     indices), csrc/egnn_tail_bwd.cu (B2, its backward), csrc/egnn_edge_fwd.cu
     and csrc/egnn_edge_bwd.cu (B3, the edge program over gathered bundles,
     forward and backward), csrc/segment.cu (B8, the segment scatter and
     gather), and the 'mega' variants: csrc/egnn_mega_paired_fwd.cu (B4, B1
     on the mirror-paired layout), csrc/egnn_tail_bwd_db.cu (B5a, B2 reading
     g[dst] itself), csrc/egnn_tail_bwd_nodes.cu (B5b, the edge half's
     backward up to node space) and csrc/egnn_stack_fwd.cu (B6, the whole
     conv stack forward), and csrc/egnn_layer_fwd.cu (B7, one whole EGNN
     layer forward), with their shared csrc/egnn_common.cuh, csrc/
     egnn_hopper.cuh (the tensor-core building blocks of B1, B2, B5a, B5b
     and B3's backward in bf16) and csrc/egnn_tail.cuh (the tail backward
     of B2, B5a and B5b);
  4. compare B1 with its plain PyTorch version on the card at the main
     path's shapes (B=128, N=288, H=64, E=2560 and 1408, F=20 and 64, 10% of
     the edges masked, self-loops), in f32 (TF32 off) and bf16, and in bf16
     at E=2560, F=64 also at B=1 (one graph over many CTAs) and B=200 (more
     graphs than SMs), output and the a1/xd residuals; time the kernel with
     and without its residual stores and the plain version, and print its
     shared memory a CTA and CTAs an SM;
  5. compare B2 with its plain version at the same shapes (its residuals
     from B1, a seeded cotangent; in bf16 also dbc1 against the sum of d_p3
     unrounded, as B3's in phase 7), and in bf16 at E=2560, F=64 also at
     B=1 and B=200 (one graph; more graphs than SMs); the same bits twice;
     time both and print the kernel's shared memory per CTA;
  6. compare the EdgeMega gradients (B1 + B2 + the node-level backward) with
     autograd through the plain forward (f32) and with the plain backward
     (bf16) at B=128, E=2560, F=64;
  7. compare B3's forward and backward with their plain versions at the same
     shapes (bundles gathered as 'fused' gathers them, zeros for masked
     edges; a seeded cotangent; in bf16 also dbc1 against the sum of d_p3
     unrounded), check that its weight gradients are the
     same bits twice, and time all four, printing the backward's shared
     memory a CTA and CTAs an SM; at E=2560 in bf16, read the weight
     gradients of the kernel, of the plain version on the card and of the
     plain version on the CPU against the exact (float64) sums;
  8. compare one EGNN layer under 'fused' (B3 + the gathers and the
     aggregation, both summed through B8's scatter) with the same layer on
     B3's plain versions: outputs and gradients, f32 and bf16, B=128,
     E=2560, F=64;
  9. compare B8's scatter and gather with their plain versions (B=128,
     N=288, C=H+3=67, E=2560 and 1408, 10% of the edges masked, indices at
     -1 and N on masked and unmasked edges; f32 with TF32 off and bf16): the
     gather bit for bit, the scatter within its bounds (SCATTER_BF16_FLOOR),
     bit for bit the plain version run on the CPU (sums in edge order) and
     the same bits twice; time each beside its plain version and the
     nearest library call (index_add_, index_select): CUDA events, the
     device-only time (torch.profiler) and the host time per call (1,000
     calls without a sync) of both; print the bound;
  10. compare one EGNN layer under 'pallas' (B8's scatter, its gather in the
     backward, its scatter as the backward of the layer's gathers) with the
     same layer on B8's plain versions: outputs and gradients, f32 and
     bf16, B=128, E=2560, F=64;
  11. compare B4 with its plain version on mirror-paired batches (B=128,
     N=288, H=64, E=2560 and 1408, F=20 and 64, f32 and bf16, 10% of the arcs
     masked, arcs at -1 and N, self-loops): B1's bounds, its residuals
     against B1's on the same batch; time it with and without residuals,
     beside its plain version and B1;
  12. compare B5a with its plain version and with B2 on the same operands
     (bit for bit), at phase 5's shapes, the same bits twice; time it beside
     both;
  13. compare B5b with its plain version (the node sums per column, d_ef and
     the weight gradients) at phase 5's shapes, the same bits twice; time it
     beside its plain version and beside what it replaces on the 'hybrid'
     path;
  14. compare B6 (six layers, F0=20, H=64) layer by layer with the plain
     version of that layer run from the kernel's own previous h and x, f32
     and bf16, E=2560 and 1408, and in bf16 at B=1, on kernel_checks'
     inputs (stack_args; the B=1 row is its sweep's named case), bf16
     judged by its rule as the sweep and the card tests judge it (the
     plain version run on the CPU its yardstick where a unit is past its
     bound), f32 by F32_TOL; the same bits twice;
     time it with and without residuals, beside its plain version and the
     per-layer forward; print its shared memory a CTA, CTAs an SM and the
     compiler's readings;
  14a. compare B7 with its plain version at phase 4's shapes (unmasked
     edges with src or dst at -1 and N among them) and in bf16 at B=1 and
     8 (a graph over a cluster of CTAs): h' and x' per column within one
     bf16 step at the column's largest value and BF16_COL_MEAN in bf16,
     F32_TOL in f32, the same bits twice; time it beside its plain version
     and print its bound, its cluster size, shared memory a CTA, CTAs an
     SM, the clusters the card holds at once and the compiler's readings;
     then start the process that writes phase 21's and 24's clinical
     cohort (synthetic_clinical_corpus, 4,096 rows of 70 patients,
     275-residue HLA chains, seed 5) while phases 15-21 run, after the
     kernel phases, whose timings its host work would disturb;
  14b. the sweep (immunostruct_tpu_torch/ops/kernel_checks.py): each of
     the eleven kernels in bf16 on every input of its card tests, at each
     test's own seed and at 1..8 (1,049 inputs), against its plain version
     on the card, judged by the rule: every unit (row, column or tensor,
     as the check is) within its bound where the plain version run on the
     CPU on the same operands meets it, within the bound plus twice the
     CPU's own statistic where it does not; the CPU runs on the inputs past
     the bound (the rule is never tighter than the bound). One line a
     kernel (inputs, failing, past the bound, restated, the worst ratio to
     what the rule allows, the CPU's worst ratio to the bound); asserts
     that no input fails;
  15. serve full-width HybridModelv2 with seeded weights in bf16 over HTTP on
     127.0.0.1 (ephemeral port), POST requests (B=128 at E=2560, B=128 at
     E=1408, B=1): probabilities finite, in (0, 1), matching the same batch
     through aggregation='scatter', the same bits when a request is sent
     again, 6 B1 launches and no other launch per request;
  15a. the sixth slice's main path: the same model and requests through
     Scorer(fused_stack=True): probabilities within PROB_ATOL of 'scatter',
     a repeated request the same bits, exactly 6 B7 launches and no other
     per request, the median forward beside phase 15's 'mega';
  16. train full-width HybridModelv2 (bf16 over f32 master weights, Adam
     1e-3, the loss config of the JAX package's bench) on
     random_sample_batch(128, 288, E, 284) for E=2560 and 1408: the first
     step's loss and gradients under 'mega' against 'scatter' from the same
     weights, then 20 'mega' steps (6 B1 + 6 B2 + 12 B8 scatter launches
     each: B8 sums the backward's node gradients; finite loss that falls)
     and 10 'scatter' steps, with the median step time;
  16b. same seed, same bits: HybridModelv2 from one seed trained twice from
     fresh state (B=16, E=2560, bf16, three steps on one mirror-paired
     batch) under 'mega' with each variant, 'fused', 'pallas', 'onehot' and
     'auto': the losses, every parameter and every Adam moment equal bit
     for bit; 'scatter' read, not asserted;
  16a. the first full-width train step under 'onehot' and 'onehot_remat'
     against 'scatter' (phase 16's bounds) at E=2560, no kernel launched;
     torch.cuda.max_memory_allocated for one step under each and under
     'mega' (onehot_remat below onehot);
  17. the comparative twin step (HybridModelv2_Comparative, the contrastive
     term at 0.1, random_comparative_batch at E=2560): the first step's loss
     and gradients under 'mega' against 'scatter', in f32 and in bf16, then
     6 steps: 12 B1 + 12 B2 + 24 B8 scatter launches per step, finite
     loss, median step
     time. Its loss is not required to fall: the contrastive term dominates
     it and wanders with each step's noise (PERF.md, Findings);
  18. the same train step under 'fused' at both edge counts: the first
     step against 'scatter', then 20 steps with 6 B3 forward + 6 B3
     backward + 16 B8 scatter + 6 B8 gather launches each and a falling
     loss, beside phase 16's 'mega';
  19. the IEDB entry point: synthetic_corpus writes 512 samples with
     275-residue HLA chains (283-285 tokens, N padded to 288), and
     cli.train_IEDB_wFT.main runs HybridModelv2 at full width with
     --aggregation fused, bf16, batch 128, 2 epochs per stage: both stages
     finish with finite losses, both checkpoints load, the train and test
     metrics have 15 keys with the train threshold reused on test, both B3
     kernels and both B8 kernels ran in both stages and B3's forward and
     B8's scatter in inference; epoch
     times and pMHC/s printed. Then B3 forward and backward against their
     plain versions as in phase 7, on the operands the entry point gave
     B3's forward (the first of each shape: full and partial batches), in
     bf16 and cast to f32;
  20. the same train step under 'pallas' at both edge counts: the first
     step against 'scatter', then 20 steps with 26 B8 scatter + 6 B8
     gather launches each (and none of B1-B3) and a falling loss, beside
     phase 16's
     'mega' and 'scatter';
  21. the Cancer entry point, the fourth slice's main path: the corpus of
     phase 19 and synthetic_comparative_corpus's 256 cancer/WT pairs sharing its
     HLA table (N=288 on both twins); cli.train_Cancer_wFT.main runs
     HybridModelv2_Comparative at full width with --aggregation pallas,
     bf16, batch 128, the contrastive term at 0.1, 2 epochs
     per stage and the default 64 finetune batches per epoch, and its
     clinical survival validation on the clinical cohort: three stages
     in order (pretrain, comparative pretrain, comparative finetune) with
     finite losses, both checkpoints load into a fresh
     HybridModelv2_Comparative, 15 metrics on train and 17 on test (the
     train threshold reused; OS/PFS p-values in [0, 1]), both B8 kernels in
     every stage and the scatter alone in both inference passes and in the
     clinical pass, no launch of B1-B3; epoch
     times and pMHC/s printed. Then B8 against its plain versions as in
     phase 9 on the operands the entry point gave it (the first of each
     kernel, shape and dtype);
  21a. batch inference: cli.infer_IEDB_or_Cancer.main in-process on phase
     19's finetune checkpoint under --aggregation auto (6 B1 launches per
     batch) and onehot (no kernel): 51 test rows of three columns, the same
     rows and labels, probabilities within PROB_ATOL of each other; then
     --comparative on phase 21's checkpoint (12 B1 launches per batch);
  22. the twelfth slice's main path, from PDBs to p-values, begins: phase
     19's 512 graphs written back as CA PDBs (write_corpus_pdbs: named by
     their join keys, HLA chain A numbered 1-275, the peptide chain C after
     it, helix CAs), one whose CAs lie outside the subgraph's positions and
     one whose residue number does not parse; cli.featurize on the native
     library (built from native/featurizer.cc by the host's C++ compiler)
     and with --no-native: the same graphs file by file (name, x, coords,
     edge_index bit for bit), a graph of no nodes for the first odd file on
     both paths and for the second on the native path, the second in the
     numpy path's error_log.txt alone (the JAX package's outputs),
     structures/s printed for each; cli.validate_data on the featurized
     graphs with the corpus's tables returns 0 at 100% join coverage;
  23. cli.train_curriculum --stages PropIEDB,ImmunoIEDB,PropCancer,
     ImmunoCancer --comparative --model HybridModelv2_Comparative
     --aggregation mega at full width (6 EGNN layers, H=64), bf16, batch
     128, 2 epochs a stage: the IEDB stages on phase 22's featurized graphs,
     the cancer/WT stages on phase 21's pairs, the last cycled to 64
     batches an epoch: the stages in order with finite losses, resume tags
     stage1-stage4, both checkpoints load, 15 metrics per split with the
     train threshold reused on test; in every stage B2 6 launches a twin a
     step, B8's scatter twice that, B1 at least that, in inference B1 alone;
     no other kernel; epoch time and pMHC/s per stage printed. Then B1 and
     B2 against their plain versions as in phases 4 and 5, on the operands
     the curriculum gave them (the first of each shape: the featurized
     stages' N=192, the twins' N=288, full and partial batches), as it ran
     them (bf16) and cast to f32, and B8's scatter as in phase 9 on the
     operands it gave it;
  24. cli.infer_clinical_only on phase 23's finetune checkpoint over the
     clinical cohort, --aggregation mega twice and scatter, bf16, batch
     128: the valid rows' probabilities within PROB_ATOL of 'scatter', the
     invalid rows NaN and out of the per-patient loads, OS/PFS p-values in
     [0, 1] and equal to clinical_pvalues of the card's probabilities, the
     same bits on the second run, 6 B1 launches a batch under 'mega' and
     none other; rows/s printed;
  25. each 'mega' variant's first full-width HybridModelv2 train step
     (bf16) against 'scatter' from the same weights and noise, on
     build_batch's mirror-paired batch at E=2560 and 1408 (phase 16's
     bounds): 'dboth', 'inkernel', 'paired', 'stack';
  26. the fifth slice's main path, the race: cli.race_kernel_variants in-process
     at B=128, E=2560 and 1408, --paired-batch, all six variants (warm-up,
     each variant's first step, a burn-in of 3, two interleaved windows of 5
     steps ending in a value fetch): per step 'diff16' ('hybrid') 6 B1 + 6
     B2, 'dboth' 6 B1 + 6 B5a, 'inkernel' 6 B1 + 6 B5b, 'paired' 6 B4 + 6 B2,
     'stack' 1 B6 + 6 B2, each with 12 B8 scatters but 'inkernel', 'fused'
     6 + 6 B3 with 16 B8 scatters and 6 B8 gathers, no other kernel, and a
     finite
     loss that falls for each (its least over the timed steps below the
     first step's: on one fixed batch the loss spikes now and then); every
     count set to 0 before each race and read after it;
  27. serve one B=128 forward with no gradient under 'stack' and 'paired'
     (the served model, a mirror-paired batch at E=2560): probabilities
     within 5e-4 of 'scatter', the same bits twice, the variant's kernel
     alone launched;
  27a. phase 27's 'paired' forward and one 'paired' train step under
     torch.cuda.set_sync_debug_mode("error"): no host sync;
  27b. export and serve an artifact: write the served model's weights as
     a JAX-format checkpoint, export five full-width artifacts through
     cli.export_model on the card (bf16,
     N=288, L=284; (a) 'auto' -> 'mega' at B=128, (b) the same at B=1, (c)
     'fused' and (d) 'pallas' at B=128, (e) (a) with --int8; E=2560), time
     the eager server under each aggregation of (a)-(d) on the same
     requests, then load all five in a fresh process with load_exported
     (which must import no model module) and serve (a)-(d) there through
     serve --artifact over HTTP (every count set to 0 before and read
     after): each gives the eager server's bits, twice, and launches what
     its eager forward launches per call (6 B1 under 'mega'); a request of
     another shape is a 400; (e) is within 0.05 of (a); then
     torch.library.opcheck on the four kernel ops with CUDA tensors;
  28. trace forwards and train steps with torch.profiler (the Scorer's
     forwards and the Trainers' steps captured graphs, as in every phase;
     artifacts (a) and (b) called directly, eagerly; 'mega',
     'scatter' and fused_stack (B7) for the forwards, and artifacts (a)
     and (b); for the step also
     'fused', 'pallas' and 'mega' under 'stack', 'inkernel' and 'paired')
     and print the device-busy time, the device's idle share and the
     kernels that take the most device time (each csrc kernel's time by
     its label in utils/attribution.py);
  28a. cli.profile_step in this process at full width (HybridModelv2,
     B=128, N=288, L=284, E=2560, bf16, 'mega'): the train step with
     --occupancy, --inference at B=128 and B=1, --comparative (every
     count set to 0 before each run and read after it: 6 B1, 6 B2 and 12
     B8 scatters a train step, 6 B1 a forward). Each run's rows name the
     csrc kernels its path launches ([kernel:B1], [kernel:B2], [kernel:B8
     scatter]; [kernel:B1] alone for a forward) and no other, and sum to
     within 10% of phase 28's device-busy time for the same work; the
     occupancy's idle share is printed beside phase 28's 1 - busy/wall;
     the MFU of the 'mega' step from utils/flops.py (the analytic count
     over phase 28's wall and device time, against the card's peak) beside
     FlopCounterMode's count of the ATen ops;
  28b. the device-resident corpus: (a) phase 19's corpus uploaded,
     estimate_device_bytes equal to the uploaded tensors' bytes (beside
     the growth of memory_allocated and --device-data's budget for the
     card); (b) one epoch of DevicePipeline equal to BatchPipeline bit for
     bit, the val split and the shuffled train split; (c) phases 19 and 21
     ran on the device pipeline ('auto'); train_IEDB_wFT and
     train_Cancer_wFT (with its clinical pass) again with
     --no-device-data: the same per-epoch losses, checkpoint bits and
     launches per stage; then auto and --no-device-data once more (one
     epoch a stage, the Cancer run without its clinical pass), each
     stage's epoch times printed in turn, and the device's idle share over
     one epoch of each pipeline (IEDB finetune 'fused', Cancer stage 3
     'pallas'); (d) train_IEDB_wFT --device-data --self-supervision
     --sequence-pad-count 5 --structure-pad-count 5 --aggregation mega
     twice (finite losses, the same bits), every augmented batch of one
     epoch held on the card against the plain gather and the generator's
     draws (pairwise CA distances kept, one all-ones row a graph with a
     real residue and its class in aux_residue, the drawn rows zeroed but
     the SSL row, 5 'J' positions in the HLA region), and gather_batch and
     augment_batch under torch.cuda.set_sync_debug_mode("error"); (e)
     27,000 rows at N=288, E=1280 uploaded (bytes, time) and a B=128
     gather_batch timed (device and host us) beside the host pipeline's
     assembly and copy of the same rows;
  29. parallelism (parallel/*; "parallel 29" lines, with the card's name
     and power limit): (a) train_IEDB_wFT under 'mega' and train_Cancer_wFT
     under 'pallas' on phase 19/21's corpora, one epoch a stage (Cancer
     without its clinical pass), with --data-parallel (a group of one over
     NCCL, joined in this process) and without: the same checkpoint bits,
     losses and launches; the NCCL all_reduce of the flagship's flat f32
     gradient buffer timed; (b) two ranks sharing the card over gloo
     (parallel/dryrun.py::spawn, the kernels built here first): the
     full-width HybridModelv2 'mega' step at a global B=128 (64 a rank,
     E=2560) in f32 against the one-process step (loss rel 1e-5,
     parameters rtol 2e-5, atol 2e-6), the twin step with contrastive 0.1
     (loss rel 2e-5) and its control twin_fixed (dropout 0, VAE noise
     pinned) at three seeds, whose one-process step is also taken on its
     rows reversed: the twin steps and the reversed ones within
     dryrun.twin_excess's rule (gradients: phase 29c's rule plus 1e-5 of
     the step's largest gradient; parameters: JAX's bound but at entries
     whose reference gradient is nonzero and below that, dropped and
     counted), each also read against JAX's bounds alone; the bf16 step
     (phase 16's first-step bounds),
     shard_map_train_step's ring against psum (loss rel 1e-5), each rank's
     launches (the one-process step's: 6 B1, 6 B2), step time and the
     gloo all_reduce of the gradient buffer; (c) the full-width twin model
     at a global B=32, f32, VAE noise pinned, against the dense step: TP
     over 2 ranks, TP x DP on (2, 2), GPipe over 5 ranks (2 microbatches;
     6 B1 and 6 B2 a stage): loss rtol 2e-5, gradients rtol 2e-4, atol
     2e-4 * max|g| on every rank; the phase's time;
  30. the contrastive term under gradient accumulation ("accum 30"
     lines): (a) the full-width twin Trainer step (B=128, E=2560, 'mega',
     contrastive 0.1) at grad_accum_steps=2, bf16 and f32: refused before
     any launch without allow_microbatch_contrastive; with it 24 B1, 24
     B2, 48 B8 scatters a step and, bit for bit, the two half-batch steps
     on one generator summed then halved; its time in turn with the k=1
     step's (bf16); (b) train_Cancer_wFT --grad-accum-steps 2
     --allow-microbatch-contrastive under 'pallas' on phase 21's corpora,
     one epoch a stage, with --data-parallel (a group of one) and
     without: the same bits, losses and launches; train_IEDB_wFT
     --wandb-username with a stand-in wandb module: every JSONL line
     logged there;
  31. the captured programs (utils/capture.py; "captured 31" lines, with
     the card's name and power limit): (a) 20 full-width 'mega' train
     steps (HybridModelv2, B=128, E=2560, bf16) through a Trainer that
     captures (the first step eager, the second captured, 18 replays) and
     20 through one that does not (``capture=False``), from the same
     weights and seed: the same losses, parameters and Adam moments bit for
     bit, 6 B1 + 6 B2 + 12 B8 scatter launches a step on both (the counts
     follow the replays); then 5 eval steps of the captured Trainer; (b)
     20 requests at B=128 and at B=1 (E=2560) through a captured Scorer
     and an eager one in turn, and through artifacts (a) and (b) of phase
     27b loaded twice, one ArtifactScorer captured and one not: the same
     bits, 6 B1 a call. Printed for each: the median walls captured and
     eager, the device's busy time and idle share (torch.profiler over
     traced calls: 1 - busy/wall, and utils/attribution.py's occupancy),
     the host's ATen calls a call, the capture time, the peak device
     memory (allocated and reserved), the replays and the launches by
     kernel. The counts of a replay are added by the program, not by the
     wrappers, so each traced window also counts the csrc kernels by name
     in the profiler's trace (utils/attribution.py's labels) and asserts
     that they equal the counters' increments over the same calls,
     captured and eager;
  32. print the times beside the card's name and power limit, then the
     kernel record (eleven kernels) as one JSON line, the card line and, last,
     the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B, N, H, L = 128, 288, 64, 284
EDGE_COUNTS = (2560, 1408)
REQUESTS = (("B=128 E=2560", 128, 2560), ("B=128 E=1408", 128, 1408),
            ("B=1 E=2560", 1, 2560))
F32_TOL = dict(atol=1e-5, rtol=1e-4)
# bf16: the kernels and their plain versions round at the same points, so
# they differ only where a different f32 summation order flips one
# rounding. B1, per output column (H message sums, 3 coordinate sums), over
# all graphs and nodes: max|diff| <= BF16_COL_MAX * max|plain| (one bf16
# step at the column's largest value) and mean|diff| <= BF16_COL_MEAN *
# mean|plain|. A kernel that leaves out any one rounding point fails the
# mean bound (tests/test_torch_port_cuda.py builds such kernels).
BF16_COL_MAX = 4e-3
BF16_COL_MEAN = 1e-4
# B2, bf16, per row of d_cat (over graphs and edges), for d_ef and for each
# weight gradient: mean|diff| <= TAIL_MEAN * mean|plain|; max|diff| <=
# TAIL_MAX_EDGE * max|plain| for d_cat and d_ef (four bf16 steps: one
# flipped rounding moves the rest of its edge's chain), TAIL_MAX_GRAD for
# the weight gradients. f32: d_cat, d_ef as F32_TOL; the weight gradients
# (f32 sums over every edge) |diff| <= 1e-5 * max|plain| + 1e-4 * |plain|.
TAIL_MEAN = 2e-5
TAIL_MAX_EDGE = 1.6e-2
TAIL_MAX_GRAD = 1e-3
# EdgeMega gradients against the plain path, per input: f32 |diff| <=
# 1e-4 * max|plain| + 1e-3 * |plain| (other summation orders through the
# whole backward); bf16 (both round at the JAX backward's points, and the
# plain gradients are cast to the inputs' dtypes as EdgeMega casts them)
# mean|diff| <= GRAD_BF16_MEAN * mean|plain| (the CPU tests' bound against
# the JAX backward).
GRAD_BF16_MEAN = 1e-4
PROB_ATOL = 5e-4          # served probabilities vs the 'scatter' path, bf16
# first train step, bf16, 'mega' against 'scatter' (they round at other
# points in the forward): |loss diff| <= STEP_LOSS_RTOL * |loss|, and per
# parameter ||grad diff|| <= STEP_GRAD_RTOL * ||grad scatter|| +
# STEP_GRAD_ATOL * (the largest ||grad scatter|| of any parameter). An H100
# run read 1.2e-5 on the loss and gradients within 3.4% of a bound 5x this
# wide (||grad diff|| <= 0.34% of ||grad||).
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_RTOL = 0.02
STEP_GRAD_ATOL = 2e-4
# the twin step's first step, 'mega' against 'scatter'. f32 (TF32 off):
# |loss diff| <= TWIN_F32_LOSS_RTOL * |loss|, ||grad diff|| <= TWIN_F32_RTOL
# * ||grad|| + TWIN_F32_ATOL * (the largest ||grad||); an H100 run read the
# same loss and ||grad diff|| <= 1e-5 * ||grad||. bf16: the loss as above,
# ||grad diff|| <= TWIN_BF16_NOISE * ||grad scatter bf16 - grad scatter
# f32|| + STEP_GRAD_ATOL * (the largest ||grad||). The twin model's fusion
# attention is sensitive to bf16: the plain path's own bf16 gradients moved
# 6.7% (of ||grad||) from its f32 ones, and 'mega' differed from 'scatter'
# by 4.0%, on combined_attention.w_concat.w (PERF.md, Findings).
TWIN_F32_LOSS_RTOL = 1e-5
TWIN_F32_RTOL = 1e-3
TWIN_F32_ATOL = 1e-5
TWIN_BF16_NOISE = 2.0
# B3, forward and backward, against its plain versions: f32 edge outputs as
# F32_TOL, weight gradients as B2's; bf16 per row of the [B, C, E] outputs
# (over graphs and edges) and for def, B2's bounds (TAIL_MEAN,
# TAIL_MAX_EDGE): the same chain, rounded at the same points.
# tests/test_torch_port_cuda.py builds B3 mutant kernels, each without one
# rounding point, that fail them. The bf16 backward is judged by the card
# tests' bounds under kernel_checks' rule at every size (the weight
# gradients' mean 2e-5 of their mean; dbc1, dsmall's bc1 column, nearer
# the plain version's than the sum of d_p3 unrounded): a unit past its
# bound where the plain version run on the CPU also is may reach the bound
# plus twice the CPU's distance. At B=128 each weight gradient sums 16x
# the card tests' edges, and other f32 orders flip other bf16 roundings
# along the per-edge chains (B3 recomputes a1 itself, where B2 is handed
# B1's): against the float64 sums of the plain version's own terms an H100
# run read at E=2560 the plain version 2e-7 to 7e-7, the kernel 1.2e-5 to
# 4.2e-5 and the plain version run on the CPU 7e-6 to 3.0e-5. Every
# backward mutant fails the rule at this shape
# (test_edge_bwd_smoke_bound_sees_every_rounding_point).
# Least time for a kernel's work (NVIDIA's H100 SXM data sheet at 700 W): device memory 3.35 TB/s; 989 TFLOP/s for bf16
# operands (tensor cores), 67 TFLOP/s for f32 (outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TIMED_REQUESTS = 5
TRAIN_STEPS = 20
SCATTER_STEPS = 10
COMPARATIVE_STEPS = 6
# the entry point at full width: synthetic_corpus with 275-residue HLA
# chains (283-285 tokens, N padded to 288), two epochs per stage
CLI_SAMPLES = 512
CLI_EPOCHS = 2
METRIC_KEYS = 15
# the Cancer entry point: 256 cancer/WT pairs sharing the IEDB corpus's HLA
# table (N=288 on both twins), the flagship's finetune floor of 64 batches
CANCER_PAIRS = 256
MIN_FINETUNING_BATCHES = 64
# the clinical cohort: the reference's 70 patients, 4,096 of its ~29K pMHC
# rows (tests/test_real_clinical.py), 275-residue HLA chains as the corpora
CLINICAL_ROWS = 4096
CLINICAL_PATIENTS = 70
# B8's scatter, bf16: within one bf16 step of the larger magnitude, or of
# this floor below it (near a cancellation the f32 roundoff of a sum of
# terms of size ~1 can exceed a step there); f32: within 2 * k * 2^-24 *
# (the sum of |m| over the element's k edges), the bound of two f32 sums of
# the same terms in other orders (the plain version sums with atomics).
# tests/test_torch_port_cuda.py builds a scatter that accumulates in bf16,
# which fails it.
SCATTER_BF16_FLOOR = 2.0 ** -10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def alternate_ms(plain, kernel) -> tuple:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    plain_ms = cuda_ms(plain)
    ms = (cuda_ms(kernel) + cuda_ms(kernel)) / 2
    return ms, (plain_ms + cuda_ms(plain)) / 2


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: int, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(mem_ms, ops_ms),
                bound_by="bytes" if mem_ms >= ops_ms else "operations")


def rel_stats(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The worst row's max and mean of |out - ref|, each relative to the
    same statistic of |ref| in that row. Rows: dim 0 after flattening the
    rest."""
    diff = (out.float() - ref.float()).abs().flatten(1)
    mag = ref.float().abs().flatten(1)
    tiny = torch.finfo(torch.float32).tiny
    return dict(
        max_rel=(diff.amax(1) / mag.amax(1).clamp_min(tiny)).max().item(),
        mean_rel=(diff.mean(1) / mag.mean(1).clamp_min(tiny)).max().item())


def bf16_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """B1: the worst output column's max and mean of |out - ref|, each
    relative to the same statistic of |ref| in that column."""
    s = rel_stats(out.flatten(0, 1).T, ref.flatten(0, 1).T)
    return dict(col_max_rel=s["max_rel"], col_mean_rel=s["mean_rel"])


def kernel_inputs(b: int, e: int, f: int, dtype, seed: int):
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer
    from immunostruct_tpu_torch.ops.mega import pack_params

    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    src = torch.randint(0, N, (b, e), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, N, (b, e), generator=gen, dtype=torch.int32)
    src[:, :8] = dst[:, :8]                                  # self-loops
    mask = torch.rand(b, e, generator=gen) >= 0.1            # 10% padded
    ef = torch.randn(b, e, 1, generator=gen)
    h = torch.randn(b, N, f, generator=gen)
    x = torch.randn(b, N, 3, generator=gen)
    layer = EGNNLayer(f, H, H, generator=gen, device=dev)
    weights = [w.detach().contiguous()
               for w in pack_params(layer.edge_mlp, layer.coord_mlp)]
    return (src.to(dev), dst.to(dev), mask.to(dev), ef.to(dev, dtype),
            h.to(dev, dtype), x.to(dev, dtype), *weights)


def residual_errors(got, ref, dtype) -> float:
    """Worst |diff| of a1/xd against the plain version, in units of the
    allowed one (f32: atol + rtol*|ref|; bf16: one bf16 step at the value,
    or at 2^-10 below that: a1 is an f32 sum of terms of size ~1)."""
    worst = 0.0
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            allowed = F32_TOL["atol"] + F32_TOL["rtol"] * r.abs()
        else:
            mag = torch.maximum(torch.maximum(g.abs(), r.abs()),
                                torch.tensor(2.0 ** -10, device=g.device))
            allowed = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        worst = max(worst, ((g - r).abs() / allowed).max().item())
    return worst


def fwd_errors(out, ref, dtype) -> tuple:
    """B1's (or B4's) aggregate against its plain version; asserts the
    bounds above. (max |diff|, the bf16 column statistics, the bound)."""
    assert out.shape == ref.shape and out.shape[2] == H + 3
    assert out.dtype == torch.float32
    assert torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, **F32_TOL)
        return err, {}, f"atol={F32_TOL['atol']} rtol={F32_TOL['rtol']}"
    rel = bf16_errors(out, ref)
    assert rel["col_max_rel"] <= BF16_COL_MAX, rel
    assert rel["col_mean_rel"] <= BF16_COL_MEAN, rel
    return err, rel, (f"per column: max <= {BF16_COL_MAX}*max|ref|, "
                      f"mean <= {BF16_COL_MEAN}*mean|ref|")


# B1's shapes: the main path's, and the grid's edge cases in bf16 at
# E=2560, F=64: one graph (its edges over many CTAs), more graphs than SMs
FWD_CASES = ([(B, e, f, name, dtype) for e in EDGE_COUNTS for f in (20, 64)
              for name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16))]
             + [(b, 2560, 64, "bfloat16", torch.bfloat16) for b in (1, 200)])


def occupancy(lib, entry: str, size: int, dtype) -> dict:
    """Shared memory per CTA of a kernel's main kernel and the CTAs of it
    that fit on one SM (B1: size N; B3's backward: size F)."""
    bf16 = int(dtype == torch.bfloat16)
    return dict(smem_per_cta=getattr(lib, f"{entry}_smem_bytes")(size, H,
                                                                   bf16),
                ctas_per_sm=getattr(lib, f"{entry}_ctas_per_sm")(size, H,
                                                                 bf16))


def check_fwd_case(args, where: str) -> dict:
    """B1 on one set of operands (src, dst, mask, ef, h, x and the packed
    weights) against its plain version: the output (fwd_errors) and the
    a1/xd residuals (residual_errors), the output without residuals too;
    timed with and without them beside the plain version."""
    from immunostruct_tpu_torch.ops import mega
    from immunostruct_tpu_torch.ops.mega import (
        edge_mega_fwd, edge_mega_fwd_reference, valid_edges,
    )

    b, n, f = args[4].shape
    e, dtype = args[0].shape[1], args[4].dtype
    out, a1, xd = edge_mega_fwd(*args, residuals=True)
    torch.cuda.synchronize()
    ref, a1_ref, xd_ref = edge_mega_fwd_reference(*args)
    err, rel, tol = fwd_errors(out, ref, dtype)
    res_err = residual_errors((a1, xd), (a1_ref, xd_ref), dtype)
    assert res_err <= 1.0, res_err
    out_nores = edge_mega_fwd(*args, residuals=False)[0]
    torch.testing.assert_close(out_nores, out, atol=1e-5, rtol=1e-5)
    ms, plain_ms = alternate_ms(
        lambda: edge_mega_fwd_reference(*args),
        lambda: edge_mega_fwd(*args, residuals=False))
    res_ms = cuda_ms(lambda: edge_mega_fwd(*args, residuals=True))
    # the work of the launch with residuals: node projections and the
    # edge chain's two HxH products on the valid edges
    valid = valid_edges(*args[:3], n).sum().item()
    flops = 2 * b * n * f * 2 * H + 2 * valid * 2 * H * H
    work = bound(tensor_bytes(*args, out, a1, xd), flops, dtype)
    # serving's launch: the same work without the a1/xd stores
    bare = bound(tensor_bytes(*args, out), flops, dtype)
    row = dict(shapes=where, B=b, N=n, E=e, F=f,
               dtype=str(dtype).split(".")[1], max_abs_err=err, **work,
               bound_ms_without_residuals=bare["bound_ms"],
               bound_by_without_residuals=bare["bound_by"],
               max_abs_ref=ref.abs().max().item(), **rel,
               tolerance=tol, residual_err_in_tol=res_err,
               ms=ms, ms_with_residuals=res_ms, plain_ms=plain_ms,
               **occupancy(mega._fwd_lib(), "egnn_mega_fwd", n, dtype))
    print("kernel B1:", json.dumps(row), flush=True)
    return row


def check_fwd_kernel() -> list:
    rows = []
    for b, e, f, _, dtype in FWD_CASES:
        rows.append(check_fwd_case(kernel_inputs(b, e, f, dtype, seed=e + f),
                                   "bench"))
    return rows


def tail_inputs(e: int, f: int, dtype, seed: int, b: int = B):
    """B2's operands: B1's residuals on seeded inputs, and a seeded node
    cotangent gathered at dst (zero on skipped edges)."""
    from immunostruct_tpu_torch.ops.mega import edge_mega_fwd, valid_edges

    args = kernel_inputs(b, e, f, dtype, seed)
    src, dst, mask, ef = args[:4]
    _, a1, xd = edge_mega_fwd(*args, residuals=True)
    valid = valid_edges(src, dst, mask, N)
    g = torch.randn(b, N, H + 3, generator=torch.Generator().manual_seed(seed))
    d = torch.where(valid, dst, 0).long()[..., None].expand(-1, -1, H + 3)
    d_both = torch.gather(g.to("cuda", dtype), 1, d)
    d_both = torch.where(valid[..., None], d_both, 0.0)
    return (ef, *args[7:], a1, xd, d_both.transpose(1, 2).contiguous(), valid)


def dbc1_nearness(kernel: str, k, r, u) -> float:
    """mean|dbc1 - plain| / mean|dbc1 - the sum of d_p3 unrounded| for a
    bf16 backward of the edge chain (dbc1 ``k``: dsmall's bc1 column; ``r``
    the plain version's, ``u`` the sum of d_p3 unrounded): at most 1 when
    the kernel rounds d_p3 before that sum as the plain version does, which
    no bound on dsmall's rows sees; asserted."""
    near = (k - r).abs().mean().item()
    far = (k - u).abs().mean().item()
    assert near <= far, (f"{kernel} dbc1 nearer the sum of d_p3 unrounded",
                         near, far)
    return near / far if far > 0 else 0.0


def tail_errors(out, ref, dtype, args=None) -> dict:
    """B2 against its plain version; asserts the bounds above, and in bf16,
    given B2's operands ``args``, dbc1_nearness."""
    assert out[0].dtype == out[1].dtype == dtype
    for t in out:
        assert torch.isfinite(t).all()
    if dtype == torch.float32:
        for g, r in zip(out[:2], ref[:2]):
            torch.testing.assert_close(g, r, **F32_TOL)
        for g, r in zip(out[2:], ref[2:]):
            assert ((g - r).abs() <= 1e-5 * r.abs().max()
                    + 1e-4 * r.abs()).all()
        return dict(max_abs_err=max((g.float() - r.float()).abs().max().item()
                                    for g, r in zip(out, ref)))
    stats = dict(
        d_cat=rel_stats(out[0].transpose(0, 1), ref[0].transpose(0, 1)),
        d_ef=rel_stats(out[1].flatten()[None], ref[1].flatten()[None]),
        weights={k: rel_stats(g.flatten()[None], r.flatten()[None])
                 for k, g, r in zip(("dw2", "dwc1", "dsmall"), out[2:],
                                    ref[2:])})
    for key in ("d_cat", "d_ef"):
        assert stats[key]["max_rel"] <= TAIL_MAX_EDGE, stats
        assert stats[key]["mean_rel"] <= TAIL_MEAN, stats
    for s in stats["weights"].values():
        assert s["max_rel"] <= TAIL_MAX_GRAD, stats
        assert s["mean_rel"] <= TAIL_MEAN, stats
    stats["max_abs_err"] = max((g.float() - r.float()).abs().max().item()
                               for g, r in zip(out, ref))
    if args is not None:
        from immunostruct_tpu_torch.ops.mega import (
            BC1, tail_d_p3_unrounded_sum,
        )

        stats["dbc1_rounding"] = dbc1_nearness(
            "B2", out[4][:, BC1], ref[4][:, BC1],
            tail_d_p3_unrounded_sum(*args))
    return stats


# the tail kernels' (B2, B5a, B5b) shapes: the main path's, and the grid's
# edge cases in bf16 at E=2560, F=64: one graph, and more graphs than SMs
TAIL_CASES = ([(B, e, f, name, dtype) for e in EDGE_COUNTS for f in (20, 64)
               for name, dtype in (("float32", torch.float32),
                                   ("bfloat16", torch.bfloat16))]
              + [(b, 2560, 64, "bfloat16", torch.bfloat16) for b in (1, 200)])


def tail_smem(entry: str, dtype) -> int:
    """Shared memory per CTA of a tail kernel's main kernel."""
    from immunostruct_tpu_torch.ops import mega

    lib = {"egnn_tail_bwd": mega._tail_lib,
           "egnn_tail_bwd_db": mega._tail_db_lib,
           "egnn_tail_bwd_nodes": mega._tail_nodes_lib}[entry]()
    return getattr(lib, f"{entry}_smem_bytes")(H, int(dtype == torch.bfloat16))


def check_tail_case(args, where: str, f=None) -> dict:
    """B2 on one set of operands (ef, w2, wc1, small, a1, xd, d_both,
    valid) against its plain version (tail_errors), the same bits twice;
    timed beside the plain version. ``f``: the layer's input width, where
    known (B2 does not read it)."""
    from immunostruct_tpu_torch.ops.mega import tail_bwd, tail_bwd_reference

    b, _, e = args[4].shape
    dtype = args[4].dtype
    out = tail_bwd(*args)
    torch.cuda.synchronize()
    ref = tail_bwd_reference(*args)
    stats = tail_errors(out, ref, dtype, args)
    again = tail_bwd(*args)
    assert all(torch.equal(g, h) for g, h in zip(out, again)), \
        "B2 changed from one run to the next"
    ms, plain_ms = alternate_ms(
        lambda: tail_bwd_reference(*args),
        lambda: tail_bwd(*args))
    # six HxH products per valid edge
    work = bound(tensor_bytes(*args, *out),
                 2 * args[-1].sum().item() * 6 * H * H, dtype)
    row = dict(shapes=where, B=b, E=e, F=f, dtype=str(dtype).split(".")[1],
               **stats, **work, ms=ms, plain_ms=plain_ms,
               smem_per_cta=tail_smem("egnn_tail_bwd", dtype))
    print("kernel B2:", json.dumps(row), flush=True)
    return row


def check_tail_kernel() -> list:
    rows = []
    for b, e, f, _, dtype in TAIL_CASES:
        rows.append(check_tail_case(
            tail_inputs(e, f, dtype, seed=e + f + 1, b=b), "bench", f))
    return rows


def check_edge_mega_grads() -> list:
    """EdgeMega's gradients (B1 + B2 + edge_half_bwd) against the plain
    path at B=128, E=2560, F=64."""
    from immunostruct_tpu_torch.ops.mega import (
        EdgeMega, edge_half_bwd, edge_mega_fwd_reference, edge_mega_reference,
        valid_edges,
    )

    rows = []
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        args = kernel_inputs(B, 2560, 64, dtype, seed=5)
        cot = torch.randn(B, N, H + 3, generator=torch.Generator()
                          .manual_seed(5)).cuda()
        leaves = [t.detach().clone().requires_grad_(True) for t in args[3:]]
        (EdgeMega.apply(*args[:3], *leaves) * cot).sum().backward()
        got = [t.grad for t in leaves]
        if dtype == torch.float32:
            # autograd through the plain forward: exact math in f32
            plain = [t.detach().clone().requires_grad_(True)
                     for t in args[3:]]
            (edge_mega_reference(*args[:3], *plain) * cot).sum().backward()
            want = [t.grad for t in plain]
        else:
            # the plain backward, which rounds where the JAX backward does
            src, dst, mask = args[:3]
            _, a1, xd = edge_mega_fwd_reference(*args)
            want = edge_half_bwd(src, dst, valid_edges(src, dst, mask, N),
                                 *args[3:], a1, xd, cot, plain=True)
        worst = 0.0
        for g, w, t in zip(got, want, args[3:]):
            g, w = g.float(), w.to(t.dtype).float().reshape(g.shape)
            assert torch.isfinite(g).all()
            if dtype == torch.float32:
                allowed = 1e-4 * w.abs().max() + 1e-3 * w.abs()
                worst = max(worst, ((g - w).abs() / allowed).max().item())
            else:
                worst = max(worst, ((g - w).abs().mean()
                                    / w.abs().mean()).item())
        bound = 1.0 if dtype == torch.float32 else GRAD_BF16_MEAN
        assert worst <= bound, (name, worst)
        row = dict(dtype=name, worst=worst, bound=bound,
                   measure=("max |diff|/allowed" if dtype == torch.float32
                            else "max over inputs of mean|diff|/mean|plain|"))
        print("EdgeMega gradients:", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def write_requests(tmp: str) -> list:
    from immunostruct_tpu_torch.data.synthetic import write_example

    paths = []
    for label, b, e in REQUESTS:
        path = os.path.join(tmp, f"req_b{b}_e{e}.npz")
        write_example(path, batch=b, nodes=N, edges=e, seq_len=L)
        paths.append((label, b, path))
    return paths


def full_width_scorer():
    from immunostruct_tpu_torch.serving import build_scorer, parser

    args = parser().parse_args(
        ["--http", "0", "--device", "cuda", "--model", "HybridModelv2",
         "--compute-dtype", "bfloat16", "--aggregation", "mega",
         "--seq-len", str(L), "--seed", "1"])
    return build_scorer(args)


def plain_probs(scorer, path):
    """The request's probabilities through the plain 'scatter' path, with
    the VAE noise the server draws for every request."""
    from immunostruct_tpu_torch.models.trunk import model_apply
    from immunostruct_tpu_torch.serving import request_to_args

    graph, seq, props = request_to_args(path, scorer.device, scorer.model)
    with torch.inference_mode():
        out = model_apply(scorer.model, graph, seq, props,
                          generator=scorer.generator(), deterministic=True,
                          aggregation="scatter",
                          compute_dtype=scorer.compute_dtype)
        return torch.sigmoid(out.logits.reshape(-1)).double().cpu()


def _counted():
    """The eleven launch wrappers, in read_counts' order."""
    from immunostruct_tpu_torch.ops import launch_counters

    wrappers = launch_counters()
    return tuple(wrappers[k] for k in ("B1", "B2", "B3_fwd", "B3_bwd",
                                       "B8_scatter", "B8_gather", "B4",
                                       "B5a", "B5b", "B6", "B7"))


def reset_counts():
    for fn in _counted():
        fn.launches = 0


def read_counts() -> tuple:
    """(B1, B2, B3 forward, B3 backward, B8 scatter, B8 gather, B4, B5a,
    B5b, B6, B7) launches."""
    return tuple(fn.launches for fn in _counted())


B7_INDEX = 10                   # B7's place in read_counts()


def check_serving(scorer, requests, kernel: int = 0) -> tuple:
    """Serve ``requests`` over HTTP: each request launches ``kernel`` (its
    index in read_counts(): B1 under 'mega', B7 under fused_stack) once per
    layer and no other kernel; its probabilities are within PROB_ATOL of
    'scatter''s and, sent again, the first reply's bits (every sum of both
    kernels is in a fixed order, without atomics)."""
    from immunostruct_tpu_torch.serving import make_http_server

    layers = len(scorer.model.gcn)
    server = make_http_server(scorer, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    rows = []
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        bodies = []
        for _, _, path in requests:
            with open(path, "rb") as fh:
                bodies.append(fh.read())
        reset_counts()                  # every count to 0: serving starts
        for (label, b, path), body in zip(requests, bodies):
            before = read_counts()
            status, reply = post(base + "/score", body)
            launches = tuple(a - z for a, z in zip(read_counts(), before))
            assert status == 200, reply
            want = tuple(layers if i == kernel else 0 for i in range(11))
            assert launches == want, (label, launches)
            probs = torch.tensor(reply["probs"], dtype=torch.float64)
            assert probs.shape == (b,), probs.shape
            assert torch.isfinite(probs).all()
            assert ((probs > 0) & (probs < 1)).all()
            # the same batch through the plain path, same VAE noise
            prob_err = (probs - plain_probs(scorer, path)).abs().max().item()
            assert prob_err <= PROB_ATOL, (label, prob_err)
            # latency: TIMED_REQUESTS more posts of the same request, each
            # scored as the first was, bit for bit
            walls, server_ms, repeat_err = [], [], 0.0
            before = read_counts()
            for _ in range(TIMED_REQUESTS):
                t0 = time.perf_counter()
                status, reply = post(base + "/score", body)
                walls.append((time.perf_counter() - t0) * 1e3)
                assert status == 200, reply
                server_ms.append(reply["ms"])
                again = torch.tensor(reply["probs"], dtype=torch.float64)
                repeat_err = max(repeat_err,
                                 (again - probs).abs().max().item())
            assert read_counts()[kernel] - before[kernel] == \
                layers * TIMED_REQUESTS
            assert repeat_err == 0.0, (label, repeat_err)
            row = dict(request=label, launches_per_request=launches[kernel],
                       max_abs_prob_err_vs_scatter=prob_err,
                       max_abs_prob_diff_repeated=repeat_err,
                       median_http_wall_ms=statistics.median(walls),
                       median_forward_ms=statistics.median(server_ms))
            print("served:", json.dumps(row), flush=True)
            rows.append(row)
        total = read_counts()           # read just after serving
        try:
            urllib.request.urlopen(base + "/nope", timeout=60).close()
            raise AssertionError("an unknown path was answered")
        except urllib.error.HTTPError as err:
            assert err.code == 404, err
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return rows, total


def make_trainer(name: str, aggregation: str, coeff: float = 0.0,
                 seed: int = 0, compute_dtype=torch.bfloat16,
                 mega_variant: str = "hybrid", vae_dim: int = L * 21,
                 **trainer_kw):
    """A full-width model with seeded weights, its trainer (bf16 over f32
    master weights unless ``compute_dtype`` says otherwise, Adam at 1e-3,
    the JAX bench's loss config, ``mega_variant`` under 'mega';
    ``trainer_kw``: ``Trainer``'s further arguments) and state;
    ``vae_dim`` the sequence width times 21."""
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.procedures.train import (
        Trainer, make_optimizer,
    )
    from immunostruct_tpu_torch.utils.losses import LossConfig
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    _, model = build_model(name, vae_dim, torch.Generator().manual_seed(seed),
                           device="cuda")
    trainer = Trainer(model.spec, LossConfig(vae_dim, pos_weight=1.0,
                                             sequence=True),
                      binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      coeff_contrastive=coeff, aggregation=aggregation,
                      compute_dtype=compute_dtype, mega_variant=mega_variant,
                      **trainer_kw)
    return trainer, trainer.init_state(
        model, torch.Generator().manual_seed(seed + 1))


def timed_steps(trainer, state, batch, steps: int) -> tuple:
    """``steps`` train steps; (losses, step ms), each step ending in a
    synchronize."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch, seed=0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def first_step(batch, name: str, aggregation: str, compute_dtype,
               coeff: float = 0.0, mega_variant: str = "hybrid") -> tuple:
    """The first step's loss and gradients (float64, by parameter name),
    from seeded weights and the step's seeded noise."""
    from immunostruct_tpu_torch.procedures.train import step_generator

    trainer, state = make_trainer(name, aggregation, coeff,
                                  compute_dtype=compute_dtype,
                                  mega_variant=mega_variant)
    loss = trainer.loss_and_grads(state.model, batch,
                                  step_generator(0, 0, "cuda"))
    grads = {n: p.grad.double() for n, p in state.model.named_parameters()}
    assert all(torch.isfinite(g).all() for g in grads.values()), name
    return float(loss), grads


def worst_grad(got: dict, want: dict, allowed) -> tuple:
    """(largest ||got - want|| / allowed(name) over the parameters, its
    name)."""
    ratios = {n: (got[n] - g).norm().item() / allowed(n)
              for n, g in want.items()}
    name = max(ratios, key=ratios.get)
    return ratios[name], name


def largest_norm(grads: dict) -> float:
    return max(g.norm().item() for g in grads.values())


def first_step_vs_scatter(batch, aggregation: str = "mega",
                          mega_variant: str = "hybrid") -> dict:
    """HybridModelv2's first step in bf16 under ``aggregation`` ('mega',
    with ``mega_variant``, 'fused' or 'pallas') against 'scatter', from the
    same weights and the same noise."""
    lm, gm = first_step(batch, "HybridModelv2", aggregation, torch.bfloat16,
                        mega_variant=mega_variant)
    ls, gs = first_step(batch, "HybridModelv2", "scatter", torch.bfloat16)
    top = largest_norm(gs)
    worst, worst_name = worst_grad(
        gm, gs, lambda n: STEP_GRAD_RTOL * gs[n].norm().item()
        + STEP_GRAD_ATOL * top)
    loss_rel = abs(lm - ls) / abs(ls)
    assert loss_rel <= STEP_LOSS_RTOL, (lm, ls)
    assert worst <= 1.0, (worst_name, worst)
    return {f"loss_{aggregation}": lm, "loss_scatter": ls,
            "loss_rel_diff": loss_rel, "grad_worst_in_tol": worst,
            "grad_worst_param": worst_name}


def twin_first_step_mega_vs_scatter(batch) -> dict:
    """The comparative twin step's first step (contrastive term at 0.1),
    'mega' against 'scatter': in f32 within TWIN_F32_*, and in bf16 within
    TWIN_BF16_NOISE times the plain path's own bf16 rounding noise."""
    name, coeff = "HybridModelv2_Comparative", 0.1
    runs = {(agg, dt): first_step(batch, name, agg, dt, coeff)
            for dt in (torch.float32, torch.bfloat16)
            for agg in ("mega", "scatter")}
    (lm, gm), (ls, gs) = (runs["mega", torch.float32],
                          runs["scatter", torch.float32])
    top = largest_norm(gs)
    f32_worst, f32_name = worst_grad(
        gm, gs, lambda n: TWIN_F32_RTOL * gs[n].norm().item()
        + TWIN_F32_ATOL * top)
    f32_loss_rel = abs(lm - ls) / abs(ls)
    (lbm, gbm), (lbs, gbs) = (runs["mega", torch.bfloat16],
                              runs["scatter", torch.bfloat16])
    noise = {n: (gbs[n] - g).norm().item() for n, g in gs.items()}
    top_bf16 = largest_norm(gbs)
    bf16_worst, bf16_name = worst_grad(
        gbm, gbs, lambda n: TWIN_BF16_NOISE * noise[n]
        + STEP_GRAD_ATOL * top_bf16)
    bf16_loss_rel = abs(lbm - lbs) / abs(lbs)
    assert f32_loss_rel <= TWIN_F32_LOSS_RTOL, (lm, ls)
    assert f32_worst <= 1.0, (f32_name, f32_worst)
    assert bf16_loss_rel <= STEP_LOSS_RTOL, (lbm, lbs)
    assert bf16_worst <= 1.0, (bf16_name, bf16_worst)
    return dict(f32_loss_rel_diff=f32_loss_rel, f32_grad_worst_in_tol=f32_worst,
                f32_grad_worst_param=f32_name, loss_mega=lbm,
                loss_scatter=lbs, loss_rel_diff=bf16_loss_rel,
                grad_worst_in_tol=bf16_worst, grad_worst_param=bf16_name,
                grad_worst_rel_diff=(gbm[bf16_name] - gbs[bf16_name]).norm()
                .item() / gbs[bf16_name].norm().item(),
                grad_worst_rel_bf16_noise=noise[bf16_name]
                / gs[bf16_name].norm().item())


def check_training() -> tuple:
    """Phase 16: the train step ('mega')."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    layers = 6
    rows = []
    main_counts = (0,) * 11
    for e in EDGE_COUNTS:
        batch = random_sample_batch(B, N, e, L, seed=0, device="cuda")
        first = first_step_vs_scatter(batch, "mega")
        print(f"train first step E={e}:", json.dumps(first), flush=True)
        trainer, state = make_trainer("HybridModelv2", "mega")
        reset_counts()                  # every count to 0: training starts
        losses, ms = timed_steps(trainer, state, batch, TRAIN_STEPS)
        counts = read_counts()          # read just after the 'mega' steps
        n = layers * TRAIN_STEPS
        assert counts == (n, n, 0, 0, 2 * n) + (0,) * 6, counts
        main_counts = tuple(a + c for a, c in zip(main_counts, counts))
        assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
        assert losses[-1] < losses[0], losses
        del trainer, state
        trainer, state = make_trainer("HybridModelv2", "scatter")
        s_losses, s_ms = timed_steps(trainer, state, batch, SCATTER_STEPS)
        assert read_counts() == counts            # 'scatter' launches none
        del trainer, state
        # the first steps include the allocator's warm-up
        mega_ms = statistics.median(ms[3:])
        scatter_ms = statistics.median(s_ms[3:])
        row = dict(E=e, steps=TRAIN_STEPS,
                   launches_per_step=[c // TRAIN_STEPS for c in counts],
                   loss_first=losses[0], loss_last=losses[-1],
                   median_step_ms_mega=mega_ms,
                   median_step_ms_scatter=scatter_ms,
                   pmhc_per_s_mega=B / (mega_ms / 1e3),
                   pmhc_per_s_scatter=B / (scatter_ms / 1e3),
                   scatter_loss_first=s_losses[0],
                   scatter_loss_last=s_losses[-1], **first)
        print("train:", json.dumps(row), flush=True)
        rows.append(row)
    return rows, main_counts


def check_comparative() -> tuple:
    """Phase 17: the comparative twin step with the contrastive term."""
    from immunostruct_tpu_torch.data.synthetic import random_comparative_batch

    batch = random_comparative_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                     device="cuda")
    first = twin_first_step_mega_vs_scatter(batch)
    print(f"comparative first step E={EDGE_COUNTS[0]}:", json.dumps(first),
          flush=True)
    trainer, state = make_trainer("HybridModelv2_Comparative", "mega",
                                  coeff=0.1)
    reset_counts()                      # every count to 0: twin steps start
    losses, ms = timed_steps(trainer, state, batch, COMPARATIVE_STEPS)
    counts = read_counts()              # read just after them
    n = 12 * COMPARATIVE_STEPS
    assert counts == (n, n, 0, 0, 2 * n) + (0,) * 6, counts
    assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
    row = dict(E=EDGE_COUNTS[0], steps=COMPARATIVE_STEPS,
               launches_per_step=[c // COMPARATIVE_STEPS for c in counts],
               loss_first=losses[0], loss_last=losses[-1],
               losses=losses,
               median_step_ms=statistics.median(ms[2:]),
               pmhc_pairs_per_s=B / (statistics.median(ms[2:]) / 1e3),
               **first)
    print("comparative:", json.dumps(row), flush=True)
    return row, counts


def edge_inputs(e: int, f: int, dtype, seed: int):
    """B3's operands as the 'fused' path builds them from kernel_inputs:
    [h ++ x] bundles [B, F+3, E] gathered by src and dst (zeros for a
    masked edge), ef [B, 1, E], the packed weights; and a seeded cotangent
    of the output [B, H+3, E]."""
    src, dst, mask, ef, h, x, *weights = kernel_inputs(B, e, f, dtype, seed)
    rows = torch.cat([h, x], dim=-1)

    def bundle(idx):
        got = torch.gather(rows, 1, idx.long()[..., None].expand(-1, -1, f + 3))
        return torch.where(mask[..., None], got, 0.0).transpose(1, 2) \
            .contiguous()

    dout = torch.randn(B, H + 3, e, generator=torch.Generator()
                       .manual_seed(seed)).to("cuda", dtype)
    return (bundle(src), bundle(dst), ef.transpose(1, 2).contiguous(),
            *weights), dout


def edge_errors(out, ref, dtype) -> dict:
    """B3 against its plain version (the forward's output, or the
    backward's seven outputs); asserts the bounds above, but the bf16
    backward's, which ``b3_bwd_rule`` judges."""
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(out, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        assert g.dtype == (dtype if g.dim() == 3 else torch.float32)
    stats = dict(max_abs_err=max((g.float() - r.float()).abs().max().item()
                                 for g, r in zip(out, ref)))
    if dtype == torch.float32:
        for g, r in zip(out, ref):
            if g.dim() == 3:
                torch.testing.assert_close(g, r, **F32_TOL)
            else:
                assert ((g - r).abs() <= 1e-5 * r.abs().max()
                        + 1e-4 * r.abs()).all()
        return stats
    names = (("out",) if len(out) == 1 else
             ("dhsx", "dhdx", "def", "dw1ab", "dw2", "dwc1", "dsmall"))
    for name, g, r in zip(names, out, ref):
        if g.dim() == 3:
            s = rel_stats(g.transpose(0, 1), r.transpose(0, 1))
        else:
            s = rel_stats(g.flatten()[None], r.flatten()[None])
        if len(out) == 1:
            assert s["max_rel"] <= TAIL_MAX_EDGE, (name, s)
            assert s["mean_rel"] <= TAIL_MEAN, (name, s)
        stats[name] = s
    return stats


def b3_bwd_rule(args, dout, grads, ref) -> dict:
    """B3's bf16 backward judged by kernel_checks' rule (the card tests'
    bounds; the plain version on the CPU, run where the kernel is past a
    bound, as the yardstick); asserts it. Its readings: the worst ratio to
    what the rule allows and to the bound, the CPU's, units restated, and
    the weight gradients' worst mean ratio to the 1e-4 this script held
    them to before the rule."""
    from immunostruct_tpu_torch.ops import kernel_checks as kc
    from immunostruct_tpu_torch.ops.edge import edge_program_bwd_reference

    v = kc.judge(kc.edge_bwd_checks(args, dout, grads, ref))
    if not v["ok"]:
        cpu = kc.on("cuda", edge_program_bwd_reference(
            *kc.on("cpu", args), dout.cpu()))
        v = kc.judge(kc.edge_bwd_checks(args, dout, grads, ref, cpu))
    assert v["ok"], ("B3 bwd fails the rule", v["failing"])
    return dict(worst=v["worst"], worst_vs_bound=v["worst_vs_bound"],
                cpu_worst=v["cpu_worst"], restated=v["restated"],
                grads_mean_vs_old_1e4=max(
                    rel_stats(g.flatten()[None], r.flatten()[None])[
                        "mean_rel"] for g, r in zip(grads[3:], ref[3:]))
                / 1e-4)


def weight_grad_readings(args, dout, grads, ref) -> dict:
    """B3's bf16 weight gradients, per gradient, as mean|diff| / mean|exact|
    against ``exact``, the float64 sums of the plain version's own per-edge
    terms: for the kernel, the plain version on the card and the plain
    version on the CPU (another f32 order in every product and every sum,
    so other flipped bf16 roundings along the chain). Also the kernel and
    the CPU's plain version against the card's."""
    from immunostruct_tpu_torch.ops.edge import edge_program_bwd_reference

    exact = edge_program_bwd_reference(*args, dout,
                                       weight_sums=torch.float64)[3:]
    cpu = edge_program_bwd_reference(*(t.cpu() for t in args),
                                     dout.cpu())[3:]

    def ratio(got, want):
        got, want = got.double().cpu(), want.double().cpu()
        return ((got - want).abs().mean() / want.abs().mean()).item()

    return {name: dict(kernel_vs_exact=ratio(k, x), plain_vs_exact=ratio(p, x),
                       plain_cpu_vs_exact=ratio(c, x),
                       kernel_vs_plain=ratio(k, p),
                       plain_cpu_vs_plain=ratio(c, p))
            for name, k, p, c, x in zip(("dw1ab", "dw2", "dwc1", "dsmall"),
                                        grads[3:], ref[3:], cpu, exact)}


def dbc1_rounding(args, dout, grads, ref) -> float:
    """dbc1_nearness for B3's bf16 backward."""
    from immunostruct_tpu_torch.ops.edge import BC1, d_p3_unrounded_sum

    return dbc1_nearness("B3", grads[6][:, BC1], ref[6][:, BC1],
                         d_p3_unrounded_sum(*args, dout))


def check_edge_case(args, dout, where: str, readings: bool = False) -> list:
    """B3 forward and backward on one set of operands against their plain
    versions (the bounds above), the backward's weight gradients the same
    bits twice, all four timed (the forward also by its device time,
    ``device_ms``); a forward and a backward row, each with its kernel's
    shared memory a CTA and CTAs an SM."""
    from immunostruct_tpu_torch.ops import edge
    from immunostruct_tpu_torch.ops.edge import (
        edge_program_bwd, edge_program_bwd_reference, edge_program_fwd,
        edge_program_reference,
    )

    b, f, e = args[0].shape[0], args[0].shape[1] - 3, args[0].shape[2]
    dtype = args[0].dtype
    out = edge_program_fwd(*args)
    grads = edge_program_bwd(*args, dout)
    torch.cuda.synchronize()
    fwd = edge_errors(out, edge_program_reference(*args), dtype)
    ref = edge_program_bwd_reference(*args, dout)
    bwd = edge_errors(grads, ref, dtype)
    if dtype == torch.bfloat16:
        bwd["dbc1_rounding"] = dbc1_rounding(args, dout, grads, ref)
        bwd["rule"] = b3_bwd_rule(args, dout, grads, ref)
    if readings:
        bwd["weight_sums"] = weight_grad_readings(args, dout, grads, ref)
    again = edge_program_bwd(*args, dout)
    assert all(torch.equal(g, h) for g, h in zip(grads[3:], again[3:])), \
        "B3 weight gradients changed from one run to the next"
    fwd_ms, fwd_plain = alternate_ms(
        lambda: edge_program_reference(*args),
        lambda: edge_program_fwd(*args))
    bwd_ms, bwd_plain = alternate_ms(
        lambda: edge_program_bwd_reference(*args, dout),
        lambda: edge_program_bwd(*args, dout))
    # every edge is computed: three products forward; the backward
    # recomputes them, adds three transposed products and three
    # weight-gradient outer products
    fwd_work = bound(tensor_bytes(*args, out),
                     2 * b * e * (2 * f * H + 2 * H * H), dtype)
    bwd_work = bound(tensor_bytes(*args, dout, *grads),
                     2 * b * e * (3 * 2 * f * H + 6 * H * H), dtype)
    fwd["device_ms"] = device_ms(lambda: edge_program_fwd(*args))
    rows = []
    for kind, stats, ms, plain, work in (
            ("fwd", fwd, fwd_ms, fwd_plain, fwd_work),
            ("bwd", bwd, bwd_ms, bwd_plain, bwd_work)):
        occ = occupancy(edge._fwd_lib() if kind == "fwd" else edge._bwd_lib(),
                        f"egnn_edge_{kind}", f, dtype)
        row = dict(kernel=kind, shapes=where, B=b, E=e, F=f,
                   dtype=str(dtype).split(".")[1], **stats, ms=ms,
                   plain_ms=plain, **work, **occ)
        print(f"kernel B3 {kind}:", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def check_edge_kernels() -> list:
    """B3 forward and backward against their plain versions at the bench's
    shapes, timed; at E=2560 in bf16 with the weight gradients' readings
    against their exact sums. Each form's registers and spills first."""
    from immunostruct_tpu_torch.ops import _build

    for src in ("egnn_edge_fwd", "egnn_edge_bwd"):
        print(f"kernel B3 ptxas {src}:",
              json.dumps(_build.ptxas_readings(src)), flush=True)
    rows = []
    for e in EDGE_COUNTS:
        for f in (20, 64):
            for dtype in (torch.float32, torch.bfloat16):
                args, dout = edge_inputs(e, f, dtype, seed=e + f + 2)
                rows += check_edge_case(
                    args, dout, "bench",
                    readings=dtype == torch.bfloat16 and e == EDGE_COUNTS[0])
                del args, dout
    return rows


def check_entry_edge_kernels(operands: dict) -> list:
    """B3 against its plain versions on the operands the entry point gave
    its forward, the first call of each shape (B, F+3, E): full and partial
    batches, bf16 as the entry point ran them and cast to f32, with a
    seeded cotangent for the backward."""
    rows = []
    for key in sorted(operands, key=str):
        (b, c, e, _), args = key, operands[key]
        dout = torch.randn(b, H + 3, e, generator=torch.Generator()
                           .manual_seed(b + c + e))
        for dtype in (torch.float32, torch.bfloat16):
            cast = tuple(t.to(dtype) if t.dim() == 3 else t for t in args)
            rows += check_edge_case(cast, dout.to("cuda", dtype),
                                    "entry point")
    return rows


@contextlib.contextmanager
def plain_b3():
    """Within the block, edge_program runs B3's plain versions on CUDA
    tensors, forward and backward."""
    from immunostruct_tpu_torch.ops import edge

    saved = edge.edge_program_fwd, edge.edge_program_bwd
    edge.edge_program_fwd = edge.edge_program_reference
    edge.edge_program_bwd = edge.edge_program_bwd_reference
    try:
        yield
    finally:
        edge.edge_program_fwd, edge.edge_program_bwd = saved


def check_fused_layer_grads() -> list:
    """EdgeProgram's gradients through one EGNN layer under 'fused' (B3
    forward and backward, the gathers and the index_add_ aggregation)
    against the same layer with B3's plain versions, at B=128, E=2560,
    F=64."""
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer, egnn_apply

    rows = []
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        gen = torch.Generator().manual_seed(11)
        layer = EGNNLayer(64, H, H, generator=gen, device="cuda")
        src, dst, mask, ef, h, x = kernel_inputs(B, 2560, 64, torch.float32,
                                                 seed=11)[:6]
        cot_h = torch.randn(B, N, H, generator=gen).to("cuda", dtype)
        cot_x = torch.randn(B, N, 3, generator=gen).to("cuda", dtype)

        def run(kernels):
            layer.zero_grad()
            hin = h.to(dtype).requires_grad_(True)
            xin = x.to(dtype).requires_grad_(True)
            before = read_counts()
            with contextlib.nullcontext() if kernels else plain_b3():
                h2, x2 = egnn_apply(layer, hin, xin, src, dst, ef, mask,
                                    "fused")
                ((h2 * cot_h).float().sum()
                 + (x2 * cot_x).float().sum()).backward()
            torch.cuda.synchronize()
            launched = tuple(a - z for a, z in zip(read_counts(), before))
            # B8's scatter sums the aggregation and the two gathers'
            # backward, its gather the aggregation's backward
            assert launched == ((0, 0, 1, 1, 3, 1) + (0,) * 5 if kernels
                                else (0, 0, 0, 0, 3, 1) + (0,) * 5), launched
            return [h2.detach(), x2.detach(), hin.grad, xin.grad] + [
                p.grad.clone() for p in layer.parameters()]

        worst = 0.0
        for g, w in zip(run(True), run(False)):
            assert torch.isfinite(g).all()
            g, w = g.float(), w.float()
            if dtype == torch.float32:
                allowed = 1e-4 * w.abs().max() + 1e-3 * w.abs()
                worst = max(worst, ((g - w).abs() / allowed).max().item())
            else:
                worst = max(worst, ((g - w).abs().mean()
                                    / w.abs().mean()).item())
        limit = 1.0 if dtype == torch.float32 else GRAD_BF16_MEAN
        assert worst <= limit, (name, worst)
        row = dict(dtype=name, worst=worst, bound=limit,
                   measure=("max |diff|/allowed" if dtype == torch.float32
                            else "max over outputs and gradients of "
                                 "mean|diff|/mean|plain|"))
        print("EdgeProgram gradients ('fused' layer):", json.dumps(row),
              flush=True)
        rows.append(row)
    return rows


def check_fused_training(mega_rows) -> tuple:
    """The 'fused' train step: its first step against 'scatter', then
    TRAIN_STEPS steps with 6 B3 forward + 6 B3 backward launches each."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    layers = 6
    rows = []
    for e, mega in zip(EDGE_COUNTS, mega_rows):
        batch = random_sample_batch(B, N, e, L, seed=0, device="cuda")
        first = first_step_vs_scatter(batch, "fused")
        print(f"fused first step E={e}:", json.dumps(first), flush=True)
        trainer, state = make_trainer("HybridModelv2", "fused")
        reset_counts()                  # every count to 0: 'fused' steps
        losses, ms = timed_steps(trainer, state, batch, TRAIN_STEPS)
        counts = read_counts()          # read just after them
        n = layers * TRAIN_STEPS
        # B8's scatter: each layer's aggregation, and the backward of its
        # two gathers but in the first layer, whose h and x are inputs
        # that need no gradient; its gather: the aggregation's backward
        assert counts == (0, 0, n, n, 3 * n - 2 * TRAIN_STEPS, n) + (
            0,) * 5, counts
        assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
        assert losses[-1] < losses[0], losses
        del trainer, state
        fused_ms = statistics.median(ms[3:])
        row = dict(E=e, steps=TRAIN_STEPS,
                   launches_per_step=[c // TRAIN_STEPS for c in counts],
                   loss_first=losses[0], loss_last=losses[-1],
                   median_step_ms_fused=fused_ms,
                   pmhc_per_s_fused=B / (fused_ms / 1e3),
                   median_step_ms_mega=mega["median_step_ms_mega"],
                   pmhc_per_s_mega=mega["pmhc_per_s_mega"], **first)
        print("train fused:", json.dumps(row), flush=True)
        rows.append(row)
    return rows, counts


def check_entry_point(tmp: str) -> tuple:
    """The third slice's main path: the train_IEDB_wFT entry point at full
    width under --aggregation fused on a synthetic corpus. Returns its row and
    the operands of B3's forward, the first call of each shape."""
    from immunostruct_tpu_torch.cli import train_IEDB_wFT as cli
    from immunostruct_tpu_torch.data.synthetic import synthetic_corpus
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.ops import edge
    from immunostruct_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    graph_dir, props, hla = synthetic_corpus(
        os.path.join(tmp, "corpus"), num_samples=CLI_SAMPLES, hla_len=275,
        seed=3)
    corpus_s = time.perf_counter() - t0
    save_dir = os.path.join(tmp, "ckpt")
    stages, inferences = [], []
    real_train, real_infer = cli.train_model, cli.inference

    def train_model(config, model, train_pipe, *args, **kw):
        before = read_counts()
        model, history = real_train(config, model, train_pipe, *args, **kw)
        graphs = train_pipe.ds.graphs       # the corpus's padded shapes
        stages.append(dict(stage=kw["stage"], history=history, launches=[
            a - z for a, z in zip(read_counts(), before)],
            pipeline=type(train_pipe).__name__,
            N=graphs.max_nodes, E=graphs.max_edges,
            edges_per_graph=[int(graphs.edge_mask.sum(1).min()),
                             int(graphs.edge_mask.sum(1).max())]))
        return model, history

    def inference(*args, **kw):
        before = read_counts()
        stats = real_infer(*args, **kw)
        inferences.append([a - z for a, z in zip(read_counts(), before)])
        return stats

    # B3's forward wrapper, called as edge_program and EdgeProgram call it
    # (through the module), keeps a copy of its first operands of each
    # shape; the launch is counted in the wrapped function as before
    operands, real_fwd = {}, edge.edge_program_fwd

    def edge_program_fwd(*args):
        key = (*args[0].shape, args[0].dtype)
        if key not in operands:
            # copies that are not inference tensors (inference runs
            # under torch.inference_mode)
            with torch.inference_mode(False):
                operands[key] = [t.detach().clone() for t in args]
        return real_fwd(*args)

    argv = ["--model", "HybridModelv2", "--full-sequence", "--sequence-loss",
            "--aggregation", "fused", "--compute-dtype", "bfloat16",
            "--batch-size", str(B), "--num-epochs", str(CLI_EPOCHS),
            "--device", "cuda", "--seed", "1", "--model-save-dir", save_dir,
            "--graph-dir-IEDB", graph_dir, "--property-path-IEDB", props,
            "--hla-path", hla]
    cli.train_model, cli.inference = train_model, inference
    edge.edge_program_fwd = edge_program_fwd
    try:
        reset_counts()                  # every count to 0: the entry point
        t0 = time.perf_counter()
        train_stats, test_stats = cli.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()          # read just after the entry point
    finally:
        cli.train_model, cli.inference = real_train, real_infer
        edge.edge_program_fwd = real_fwd

    assert [s["stage"] for s in stages] == ["pretrain", "finetune"], stages
    for s in stages:
        h = s["history"]
        assert len(h["train_loss"]) == CLI_EPOCHS, h
        assert all(v == v and abs(v) < float("inf")
                   for v in h["train_loss"] + h["val_loss"]), h
        b3f, b3b, b8s, b8g = s["launches"][2:6]
        assert s["launches"][:2] == [0, 0] and b3f > 0 and b3b > 0, s
        # B8's scatter: one aggregation a forward, the backward of two
        # gathers a backward but in the first of the six layers (its h and
        # x need no gradient); its gather: the aggregation's backward
        assert b8s == b3f + 2 * (b3b - b3b // 6) and b8g == b3b, s
        assert s["launches"][6:] == [0] * 5, s
    assert len(inferences) == 2, inferences
    for launched in inferences:
        assert launched[2] > 0 and launched[4] == launched[2], launched
        assert launched.count(0) == 9, launched
    for stats in (train_stats, test_stats):
        assert len(stats) == METRIC_KEYS, sorted(stats)
    assert test_stats["optimal_threshold"] == \
        train_stats["optimal_threshold"]
    ckpts = sorted(f for f in os.listdir(save_dir) if f.endswith(".ckpt"))
    assert [c.rsplit("_", 1)[1] for c in ckpts] == ["finetune.ckpt",
                                                     "pretrain.ckpt"], ckpts
    for c in ckpts:
        path = os.path.join(save_dir, c)
        with np.load(path) as z:        # the VAE's width: the corpus's L*21
            vae_dim = z["['vae']['fc1']['w']"].shape[0]
        _, fresh = build_model("HybridModelv2", vae_dim,
                               torch.Generator().manual_seed(0),
                               device="cuda")
        load_checkpoint(path, fresh, verbose=False)
    epochs = []
    for s in stages:
        h = s["history"]
        for i, (dt, n) in enumerate(zip(h["epoch_time"],
                                        h["train_samples"])):
            epochs.append(dict(stage=s["stage"], epoch=i + 1, epoch_s=dt,
                               train_pmhc=n, pmhc_per_s=n / dt,
                               train_loss=h["train_loss"][i],
                               val_loss=h["val_loss"][i]))
    assert stages[0]["N"] == N and stages[0]["E"] % 128 == 0, stages[0]
    row = dict(save_dir=save_dir, argv=argv, infer_args=[
                   "--graph-dir-IEDB", graph_dir, "--property-path-IEDB",
                   props, "--hla-path", hla],
               pipelines=[s["pipeline"] for s in stages],
               corpus=[graph_dir, props, hla], samples=CLI_SAMPLES, N=stages[0]["N"], E=stages[0]["E"],
               edges_per_graph=stages[0]["edges_per_graph"],
               corpus_s=corpus_s, wall_s=wall_s,
               launches=counts, launches_by_stage={
                   s["stage"]: s["launches"] for s in stages},
               b3_shapes=sorted(k[:3] for k in operands),
               launches_inference=inferences, epochs=epochs,
               train_roc_auc=train_stats["roc_auc"],
               test_roc_auc=test_stats["roc_auc"],
               threshold=train_stats["optimal_threshold"])
    print("entry point:", json.dumps(row), flush=True)
    return row, operands


# --------------------------------------------------------------------------
# B8: segment scatter and gather ('pallas')
# --------------------------------------------------------------------------

def alternate3_ms(plain, kernel, library) -> tuple:
    """(kernel ms, plain ms, library ms), timed plain, library, kernel,
    kernel, library, plain."""
    plain_ms, library_ms = cuda_ms(plain), cuda_ms(library)
    ms = (cuda_ms(kernel) + cuda_ms(kernel)) / 2
    library_ms = (library_ms + cuda_ms(library)) / 2
    return ms, (plain_ms + cuda_ms(plain)) / 2, library_ms


def device_ms(fn, calls: int = 20) -> float:
    """Device time per call of ``fn`` with the host out of the way: the
    calls queued behind a spin kernel (torch.cuda._sleep) that outlasts
    their queueing, then timed back to back on the device with CUDA events
    (their kernels and the gaps between them, no host time). The spin is
    lengthened until it outlasts the queueing."""
    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    while True:
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if queued_ms < 0.8 * spin.elapsed_time(start):
            return start.elapsed_time(end) / calls
        cycles *= 4


def host_us(fn, calls: int = 1000) -> float:
    """Host time per call of ``fn``: time.perf_counter over ``calls`` calls
    with no synchronisation between them (the launches queue up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def b8_readings(kernel, library) -> dict:
    """B8's device-only and host readings beside the events ones: the
    kernel's and the library call's device time per call (``device_ms``),
    and their host time per call (``host_us``)."""
    return dict(device_ms=device_ms(kernel),
                library_device_ms=device_ms(library),
                host_us=host_us(kernel), library_host_us=host_us(library))


def segment_inputs(e: int, dtype, seed: int):
    """B8's operands at the main path's shapes: idx/mask [B, E] (10% of the
    edges masked, indices at -1 and N on masked and unmasked edges, some
    nodes repeated), m [B, E, H+3] and h [B, N, H+3]."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, N, (B, e), generator=gen, dtype=torch.int32)
    mask = torch.rand(B, e, generator=gen) >= 0.1
    idx[:, 0:4], idx[:, 4:8] = -1, N
    mask[:, 0:8:2] = False
    idx[:, 8:16] = idx[:, 16:24]
    m = torch.randn(B, e, H + 3, generator=gen)
    h = torch.randn(B, N, H + 3, generator=gen)
    return (idx.cuda(), mask.cuda(), m.to("cuda", dtype),
            h.to("cuda", dtype))


def _valid_rows(idx, mask, n):
    """The valid edges [B, E] and every edge's row of a [B*N, C] view
    (row 0 of its graph where not valid)."""
    valid = mask & (idx >= 0) & (idx < n)
    offs = torch.arange(idx.shape[0], device=idx.device)[:, None] * n
    return valid, (torch.where(valid, idx, 0).long() + offs).reshape(-1)


def scatter_errors(out, ref, idx, mask, m) -> dict:
    """B8's scatter against its plain version; asserts SCATTER_* bounds.
    Returns the max |diff| and the worst |diff| / allowed."""
    from immunostruct_tpu_torch.ops.segment import segment_scatter_reference

    n = out.shape[1]
    assert out.shape == ref.shape and out.dtype == ref.dtype == m.dtype
    assert torch.isfinite(out).all()
    got, want = out.float(), ref.float()
    diff = (got - want).abs()
    if m.dtype == torch.float32:
        abs_sum = segment_scatter_reference(idx, mask, m.abs(), n)
        count = segment_scatter_reference(
            idx, mask, torch.ones_like(m[..., :1]), n)
        allowed = 2 * count * 2.0 ** -24 * abs_sum
    else:
        mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                            torch.tensor(SCATTER_BF16_FLOOR,
                                         device=got.device))
        allowed = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert (diff <= allowed).all(), diff.max().item()
    worst = torch.where(diff > 0, diff / allowed, 0.0).max().item()
    return dict(max_abs_err=diff.max().item(), worst_in_tol=worst)


def check_scatter_case(idx, mask, m, n: int, where: str) -> dict:
    """B8's scatter on one set of operands against its plain version on
    the card (SCATTER_* bounds) and bit for bit against it on the CPU
    (index_add_ there sums each element in edge order, as the kernel
    does), the same bits twice, and timed beside the plain version and the
    nearest library call (index_add_ of the masked messages in f32 into
    [B*N, C], then one cast; the messages and rows are made before the
    timing)."""
    from immunostruct_tpu_torch.ops.segment import (
        segment_scatter, segment_scatter_reference,
    )

    b, e, c = m.shape
    dtype = m.dtype
    out = segment_scatter(idx, mask, m, n)
    torch.cuda.synchronize()
    ref = segment_scatter_reference(idx, mask, m, n)
    stats = scatter_errors(out, ref, idx, mask, m)
    assert torch.equal(out, segment_scatter(idx, mask, m, n)), \
        "B8 scatter changed from one run to the next"
    assert torch.equal(out.cpu(), segment_scatter_reference(
        idx.cpu(), mask.cpu(), m.cpu(), n)), \
        "B8 scatter is not the CPU plain version's bits"
    valid, rows = _valid_rows(idx, mask, n)
    msgs = torch.where(valid[..., None], m.float(), 0.0).reshape(b * e, c)

    def library():
        return torch.zeros(b * n, c, device=m.device).index_add_(
            0, rows, msgs).to(dtype)

    scatter_errors(library().view(b, n, c), ref, idx, mask, m)
    ms, plain_ms, library_ms = alternate3_ms(
        lambda: segment_scatter_reference(idx, mask, m, n),
        lambda: segment_scatter(idx, mask, m, n), library)
    readings = b8_readings(lambda: segment_scatter(idx, mask, m, n), library)
    # this run's data: idx and mask, the valid edges' messages, the output;
    # one f32 add per valid message element
    n_valid = int(valid.sum().item())
    work = bound(tensor_bytes(idx, mask, out) + n_valid * c * m.element_size(),
                 n_valid * c, torch.float32)
    row = dict(kernel="scatter", shapes=where, B=b, E=e, N=n, C=c,
               dtype=str(dtype).split(".")[1], valid_edges=n_valid, **stats,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms, **readings,
               **work)
    print("kernel B8 scatter:", json.dumps(row), flush=True)
    return row


def check_gather_case(idx, mask, h, where: str) -> dict:
    """B8's gather on one set of operands: bit for bit against its plain
    version, and timed beside it and the nearest library call
    (index_select, then the mask)."""
    from immunostruct_tpu_torch.ops.segment import (
        segment_gather, segment_gather_reference,
    )

    b, n, c = h.shape
    e = idx.shape[1]
    out = segment_gather(idx, mask, h)
    torch.cuda.synchronize()
    ref = segment_gather_reference(idx, mask, h)
    assert out.dtype == h.dtype and torch.equal(out, ref), "B8 gather"
    valid, rows = _valid_rows(idx, mask, n)
    hf, keep = h.reshape(b * n, c), valid[..., None]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)

    def library():
        return torch.where(keep, hf.index_select(0, rows).view(b, e, c),
                           zero)

    assert torch.equal(library(), ref)
    ms, plain_ms, library_ms = alternate3_ms(
        lambda: segment_gather_reference(idx, mask, h),
        lambda: segment_gather(idx, mask, h), library)
    readings = b8_readings(lambda: segment_gather(idx, mask, h), library)
    # this run's data: idx and mask, the node rows the valid edges read
    # (each once), the output
    used = torch.unique(rows[valid.reshape(-1)]).numel()
    work = bound(tensor_bytes(idx, mask, out) + used * c * h.element_size(),
                 0, torch.float32)
    row = dict(kernel="gather", shapes=where, B=b, E=e, N=n, C=c,
               dtype=str(h.dtype).split(".")[1], rows_read=used,
               max_abs_err=(out.float() - ref.float()).abs().max().item(),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms, **readings,
               **work)
    print("kernel B8 gather:", json.dumps(row), flush=True)
    return row


def check_segment_kernels() -> list:
    """B8 against its plain versions at the main path's shapes, f32 (TF32
    off) and bf16, timed."""
    rows = []
    for e in EDGE_COUNTS:
        for dtype in (torch.float32, torch.bfloat16):
            idx, mask, m, h = segment_inputs(e, dtype, seed=e + 3)
            rows.append(check_scatter_case(idx, mask, m, N, "bench"))
            rows.append(check_gather_case(idx, mask, h, "bench"))
            del idx, mask, m, h
    return rows


def check_entry_segment_kernels(operands: dict) -> list:
    """B8 against its plain versions on the operands the entry point gave
    it, the first call of each (kernel, shape, dtype)."""
    rows = []
    for key in sorted(operands, key=str):
        kind, args = key[0], operands[key]
        if kind == "scatter":
            rows.append(check_scatter_case(*args, "entry point"))
        else:
            rows.append(check_gather_case(*args, "entry point"))
    return rows


@contextlib.contextmanager
def plain_b8():
    """Within the block, SegmentScatter and SegmentGather run B8's plain
    versions on CUDA tensors, forward and backward."""
    from immunostruct_tpu_torch.ops import segment

    saved = segment.segment_scatter, segment.segment_gather
    segment.segment_scatter = segment.segment_scatter_reference
    segment.segment_gather = segment.segment_gather_reference
    try:
        yield
    finally:
        segment.segment_scatter, segment.segment_gather = saved


def check_pallas_layer_grads() -> list:
    """One EGNN layer under 'pallas' (B8's scatter, its gather in the
    backward) against the same layer on B8's plain versions, at B=128,
    E=2560, F=64: outputs and gradients. f32 as the 'fused' layer; bf16 per
    tensor mean|diff| <= 2 * (the plain layer's own run-to-run mean|diff|)
    + GRAD_BF16_MEAN * mean|plain|: the plain scatter (index_add_) sums with
    atomics on the card, so h's and the edge MLP's gradients move from run
    to run there."""
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer, egnn_apply

    rows = []
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        gen = torch.Generator().manual_seed(13)
        layer = EGNNLayer(64, H, H, generator=gen, device="cuda")
        src, dst, mask, ef, h, x = kernel_inputs(B, 2560, 64, torch.float32,
                                                 seed=13)[:6]
        cot_h = torch.randn(B, N, H, generator=gen).to("cuda", dtype)
        cot_x = torch.randn(B, N, 3, generator=gen).to("cuda", dtype)

        def run(kernels):
            layer.zero_grad()
            hin = h.to(dtype).requires_grad_(True)
            xin = x.to(dtype).requires_grad_(True)
            before = read_counts()
            with contextlib.nullcontext() if kernels else plain_b8():
                h2, x2 = egnn_apply(layer, hin, xin, src, dst, ef, mask,
                                    "pallas")
                ((h2 * cot_h).float().sum()
                 + (x2 * cot_x).float().sum()).backward()
            torch.cuda.synchronize()
            launched = tuple(a - z for a, z in zip(read_counts(), before))
            # the scatter sums the aggregation and the backward of the
            # layer's four gathers, the gather the aggregation's backward
            assert launched == ((0, 0, 0, 0, 5, 1) + (0,) * 5 if kernels
                                else (0,) * 11), launched
            return [h2.detach(), x2.detach(), hin.grad, xin.grad] + [
                p.grad.clone() for p in layer.parameters()]

        worst, noise_worst = 0.0, 0.0
        for g, w, w2 in zip(run(True), run(False), run(False)):
            assert torch.isfinite(g).all()
            g, w, w2 = g.float(), w.float(), w2.float()
            if dtype == torch.float32:
                allowed = 1e-4 * w.abs().max() + 1e-3 * w.abs()
                worst = max(worst, ((g - w).abs() / allowed).max().item())
            else:
                noise = (w2 - w).abs().mean()
                allowed = 2 * noise + GRAD_BF16_MEAN * w.abs().mean() + 1e-12
                worst = max(worst, ((g - w).abs().mean() / allowed).item())
                noise_worst = max(noise_worst,
                                  (noise / w.abs().mean()).item())
        assert worst <= 1.0, (name, worst)
        row = dict(dtype=name, worst_in_tol=worst,
                   plain_run_to_run_mean_rel=noise_worst,
                   measure=("max |diff|/allowed" if dtype == torch.float32
                            else "max over outputs and gradients of "
                                 "mean|diff| / (2 * plain noise + 1e-4 * "
                                 "mean|plain|)"))
        print("SegmentScatter gradients ('pallas' layer):", json.dumps(row),
              flush=True)
        rows.append(row)
    return rows


def check_pallas_training(mega_rows) -> tuple:
    """The 'pallas' train step: its first step against 'scatter', then
    TRAIN_STEPS steps with 6 B8 scatter + 6 B8 gather launches each, beside
    phase 16's 'mega' and 'scatter' steps."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    layers = 6
    rows = []
    for e, mega in zip(EDGE_COUNTS, mega_rows):
        batch = random_sample_batch(B, N, e, L, seed=0, device="cuda")
        first = first_step_vs_scatter(batch, "pallas")
        print(f"pallas first step E={e}:", json.dumps(first), flush=True)
        trainer, state = make_trainer("HybridModelv2", "pallas")
        reset_counts()                  # every count to 0: 'pallas' steps
        losses, ms = timed_steps(trainer, state, batch, TRAIN_STEPS)
        counts = read_counts()          # read just after them
        n = layers * TRAIN_STEPS
        # the scatter: each layer's aggregation and the backward of its
        # four gathers but in the first layer (h and x need no gradient)
        assert counts == (0, 0, 0, 0, 5 * n - 4 * TRAIN_STEPS, n) + (
            0,) * 5, counts
        assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
        assert losses[-1] < losses[0], losses
        del trainer, state
        pallas_ms = statistics.median(ms[3:])
        row = dict(E=e, steps=TRAIN_STEPS,
                   launches_per_step=[c // TRAIN_STEPS for c in counts],
                   loss_first=losses[0], loss_last=losses[-1],
                   median_step_ms_pallas=pallas_ms,
                   pmhc_per_s_pallas=B / (pallas_ms / 1e3),
                   median_step_ms_mega=mega["median_step_ms_mega"],
                   median_step_ms_scatter=mega["median_step_ms_scatter"],
                   **first)
        print("train pallas:", json.dumps(row), flush=True)
        rows.append(row)
    return rows, counts


def check_cancer_entry_point(tmp: str, clinical: tuple) -> tuple:
    """The fourth slice's main path: the train_Cancer_wFT entry point at
    full width under --aggregation pallas, on a synthetic IEDB corpus and
    cancer/WT pairs sharing its HLA table, with the clinical survival
    validation on the clinical cohort. Returns its row and B8's operands,
    the first call of each (kernel, shape, dtype)."""
    from immunostruct_tpu_torch.cli import train_Cancer_wFT as cli
    from immunostruct_tpu_torch.procedures import infer
    from immunostruct_tpu_torch.data.synthetic import (
        synthetic_comparative_corpus, synthetic_corpus,
    )
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.ops import segment
    from immunostruct_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    root = os.path.join(tmp, "cancer_corpus")
    graph_iedb, props_iedb, hla = synthetic_corpus(
        root, num_samples=CLI_SAMPLES, hla_len=275, seed=3)
    dir_c, dir_w, props_c, props_w, _ = synthetic_comparative_corpus(
        root, num_samples=CANCER_PAIRS, hla_len=275, seed=4,
        shared_hla_path=hla)
    corpus_s = time.perf_counter() - t0
    save_dir = os.path.join(tmp, "cancer_ckpt")
    stages, inferences = [], []
    real_train, real_infer = cli.train_model, cli.inference

    def train_model(config, model, train_pipe, *args, **kw):
        before = read_counts()
        model, history = real_train(config, model, train_pipe, *args, **kw)
        graphs = train_pipe.ds.graphs
        stages.append(dict(stage=kw["stage"], resume_tag=kw.get("resume_tag"),
                           comparative=hasattr(train_pipe, "wt"),
                           pipeline=type(train_pipe).__name__,
                           steps_per_epoch=len(train_pipe), history=history,
                           launches=[a - z for a, z in zip(read_counts(),
                                                           before)],
                           N=graphs.max_nodes, E=graphs.max_edges))
        return model, history

    def inference(*args, **kw):
        before = read_counts()
        stats = real_infer(*args, **kw)
        inferences.append([a - z for a, z in zip(read_counts(), before)])
        return stats

    # B8's launch helpers keep copies of their first operands of each
    # shape; the wrappers that call them count the launches as before
    operands = {}
    real_scatter, real_gather = segment._scatter_launch, segment._gather_launch

    def keep(kind, args):
        key = (kind, *args[2].shape, args[2].dtype)
        if key not in operands:
            with torch.inference_mode(False):
                operands[key] = tuple(
                    t.detach().clone() if torch.is_tensor(t) else t
                    for t in args)

    def scatter(*args):
        keep("scatter", args)
        return real_scatter(*args)

    def gather(*args):
        keep("gather", args)
        return real_gather(*args)

    # the clinical pass inside the test split's inference
    real_clinical, clinical_pass = infer.inference_clinical_only, []

    def inference_clinical_only(*args, **kw):
        before = read_counts()
        out = real_clinical(*args, **kw)
        clinical_pass.append([a - z for a, z in zip(read_counts(), before)])
        return out

    cli.train_model, cli.inference = train_model, inference
    segment._scatter_launch, segment._gather_launch = scatter, gather
    infer.inference_clinical_only = inference_clinical_only
    graph_clin, seq_clin, table_clin = clinical
    argv = ["--model", "HybridModelv2_Comparative", "--full-sequence",
            "--sequence-loss", "--aggregation", "pallas",
            "--compute-dtype", "bfloat16", "--batch-size", str(B),
            "--num-epochs", str(CLI_EPOCHS), "--coeff-contrastive", "0.1",
            "--device", "cuda", "--seed", "1",
            "--model-save-dir", save_dir,
            "--graph-dir-IEDB", graph_iedb, "--property-path-IEDB",
            props_iedb, "--hla-path", hla, "--graph-dir-cancer", dir_c,
            "--graph-dir-wildtype", dir_w, "--property-path-cancer", props_c,
            "--property-path-wildtype", props_w,
            "--graph-dir-clinical", graph_clin,
            "--seq-path-clinical", seq_clin,
            "--clinical-table-path", table_clin,
            "--figure-save-dir", os.path.join(tmp, "cancer_figures")]
    try:
        reset_counts()                  # every count to 0: the entry point
        t0 = time.perf_counter()
        train_stats, test_stats = cli.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()          # read just after the entry point
    finally:
        cli.train_model, cli.inference = real_train, real_infer
        segment._scatter_launch, segment._gather_launch = (real_scatter,
                                                           real_gather)
        infer.inference_clinical_only = real_clinical

    assert [(s["stage"], s["comparative"], s["resume_tag"]) for s in stages] \
        == [("pretrain", False, "stage1"), ("pretrain", True, "stage2"),
            ("finetune", True, None)], stages
    assert stages[2]["steps_per_epoch"] == MIN_FINETUNING_BATCHES, stages[2]
    for s in stages:
        h = s["history"]
        assert len(h["train_loss"]) == CLI_EPOCHS, h
        assert all(v == v and abs(v) < float("inf")
                   for v in h["train_loss"] + h["val_loss"]), h
        assert s["launches"][:4] == [0, 0, 0, 0], s
        assert s["launches"][6:] == [0] * 5, s
        assert s["launches"][4] > 0 and s["launches"][5] > 0, s
    assert len(inferences) == 2, inferences
    for launched in inferences:
        assert launched[4] > 0 and launched.count(0) == 10, launched
    assert counts[:4] == (0, 0, 0, 0) and counts[6:] == (0,) * 5, counts
    # the clinical pass: the plain forward under 'pallas', B8's scatter
    # alone (no gradient, so no gather)
    assert len(clinical_pass) == 1, clinical_pass
    assert clinical_pass[0][4] > 0 and sum(clinical_pass[0]) == \
        clinical_pass[0][4], clinical_pass
    assert len(train_stats) == METRIC_KEYS, sorted(train_stats)
    assert sorted(set(test_stats) - set(train_stats)) == [
        "os_p_value", "pfs_p_value"] and len(test_stats) == METRIC_KEYS + 2
    assert all(0.0 <= test_stats[k] <= 1.0
               for k in ("os_p_value", "pfs_p_value")), test_stats
    assert test_stats["optimal_threshold"] == \
        train_stats["optimal_threshold"]
    ckpts = sorted(f for f in os.listdir(save_dir) if f.endswith(".ckpt"))
    assert [c.rsplit("_", 1)[1] for c in ckpts] == ["finetune.ckpt",
                                                     "pretrain.ckpt"], ckpts
    for c in ckpts:
        path = os.path.join(save_dir, c)
        with np.load(path) as z:        # the VAE's width: the corpus's L*21
            vae_dim = z["['vae']['fc1']['w']"].shape[0]
        _, fresh = build_model("HybridModelv2_Comparative", vae_dim,
                               torch.Generator().manual_seed(0),
                               use_wt_for_downstream=False, device="cuda")
        load_checkpoint(path, fresh, verbose=False)
    epochs = []
    for s, label in zip(stages, ("stage 1", "stage 2", "stage 3")):
        h = s["history"]
        per = 2 if s["comparative"] else 1      # pMHCs per sample (twins)
        for i, (dt, n) in enumerate(zip(h["epoch_time"],
                                        h["train_samples"])):
            epochs.append(dict(stage=label, epoch=i + 1, epoch_s=dt,
                               steps=s["steps_per_epoch"], train_samples=n,
                               samples_per_s=n / dt, pmhc_per_s=per * n / dt,
                               train_loss=h["train_loss"][i],
                               val_loss=h["val_loss"][i]))
    assert stages[1]["N"] == N and stages[1]["E"] % 128 == 0, stages[1]
    row = dict(save_dir=save_dir, argv=argv,
               pipelines=[s["pipeline"] for s in stages], infer_args=[
                   "--graph-dir-cancer", dir_c, "--graph-dir-wildtype", dir_w,
                   "--property-path-cancer", props_c,
                   "--property-path-wildtype", props_w, "--hla-path", hla],
               iedb_samples=CLI_SAMPLES, pairs=CANCER_PAIRS,
               N=stages[1]["N"], E_iedb=stages[0]["E"], E_cancer=stages[1]["E"],
               corpus_s=corpus_s, wall_s=wall_s, launches=counts,
               launches_by_stage=[s["launches"] for s in stages],
               launches_inference=inferences,
               launches_clinical=clinical_pass[0],
               os_p_value=test_stats["os_p_value"],
               pfs_p_value=test_stats["pfs_p_value"],
               b8_shapes=sorted([k[0], *k[1:4]] for k in operands),
               epochs=epochs, train_roc_auc=train_stats["roc_auc"],
               test_roc_auc=test_stats["roc_auc"],
               threshold=train_stats["optimal_threshold"])
    print("entry point (Cancer):", json.dumps(row), flush=True)
    return row, operands


# --------------------------------------------------------------------------
# the 'mega' kernel variants: B4, B5a, B5b, B6, and the race
# --------------------------------------------------------------------------

DTYPES = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
# per train step of six layers, by the race's variant names
VARIANT_LAUNCHES = {
    "diff16": {"B1": 6, "B2": 6, "B8_scatter": 12},
    "dboth": {"B1": 6, "B5a": 6, "B8_scatter": 12},
    "inkernel": {"B1": 6, "B5b": 6},
    "paired": {"B4": 6, "B2": 6, "B8_scatter": 12},
    "stack": {"B6": 1, "B2": 6, "B8_scatter": 12},
    "fused": {"B3_fwd": 6, "B3_bwd": 6, "B8_scatter": 16, "B8_gather": 6},
}
RACE_WINDOWS, RACE_STEPS, RACE_BURNIN = 2, 5, 3
# B6, bf16, each layer run from the kernel's own previous h and x, is held
# by kernel_checks.stack_checks under its rule (aggs per column within one
# bf16 step at the column's largest |plain| and NODE_COL_MEAN of its mean,
# a1s/xds by B1's residual rule, hs/xs per column NODE_COL_MEAN); f32 by
# F32_TOL. tests/test_torch_port_cuda.py builds B6 mutant kernels, each
# without one rounding point or one near-tie recompute, that fail them.


def paired_inputs(e: int, f: int, dtype, seed: int, b: int = B):
    """kernel_inputs on the mirror-paired layout: the arc half's indices
    (arcs at -1 and N among them, self-loops) and mask, mirrored."""
    src, dst, mask, *rest = kernel_inputs(b, e, f, dtype, seed)
    half = e // 2
    s0, d0, m0 = (t[:, :half].clone() for t in (src, dst, mask))
    s0[:, 8:12] = -1
    d0[:, 12:16] = N
    return (torch.cat([s0, d0], 1), torch.cat([d0, s0], 1),
            torch.cat([m0, m0], 1), *rest)


# B4's shapes: the race's, and one graph (its arcs over many CTAs in bf16)
PAIRED_CASES = ([(B, e, f, name, dtype) for e in EDGE_COUNTS for f in (20, 64)
                 for name, dtype in DTYPES]
                + [(1, 2560, 64, "bfloat16", torch.bfloat16)])


def check_paired_kernel() -> list:
    """B4 against its plain version on paired batches, timed beside it and
    beside B1 on the same batch (whose residuals it should equal); its
    shared memory, CTAs an SM and each form's registers and spills."""
    from immunostruct_tpu_torch.ops import _build, mega
    from immunostruct_tpu_torch.ops.mega import (
        check_paired, edge_mega_fwd, edge_mega_paired_fwd,
        edge_mega_paired_fwd_reference, mirror_edges, valid_edges,
    )

    print("kernel B4 ptxas:", json.dumps(
        _build.ptxas_readings("egnn_mega_paired_fwd")), flush=True)
    rows = []
    for b, e, f, name, dtype in PAIRED_CASES:
        args = paired_inputs(e, f, dtype, seed=e + f + 2, b=b)
        check_paired(*args[:3])
        out, a1, xd = edge_mega_paired_fwd(*args)
        torch.cuda.synchronize()
        ref, a1_ref, xd_ref = edge_mega_paired_fwd_reference(*args)
        err, rel, tol = fwd_errors(out, ref, dtype)
        res_err = residual_errors((a1, xd), (a1_ref, xd_ref), dtype)
        assert res_err <= 1.0, res_err
        _, a1_b1, xd_b1 = edge_mega_fwd(*args)
        same = torch.equal(a1, a1_b1) and torch.equal(xd, xd_b1)
        ms, plain_ms = alternate_ms(
            lambda: edge_mega_paired_fwd_reference(*args),
            lambda: edge_mega_paired_fwd(*args))
        b1_ms = cuda_ms(lambda: edge_mega_fwd(*args))
        bare_ms = cuda_ms(lambda: edge_mega_paired_fwd(
            *args, residuals=False))
        valid = valid_edges(*mirror_edges(*args[:3]), N).sum().item()
        flops = 2 * b * N * f * 2 * H + 2 * valid * 2 * H * H
        # the arc half of src, dst and mask is read
        nbytes = (tensor_bytes(*args[3:], out, a1, xd)
                  + tensor_bytes(*args[:3]) // 2)
        row = dict(B=b, E=e, F=f, dtype=name, max_abs_err=err,
                   **bound(nbytes, flops, dtype), **rel,
                   tolerance=tol, residual_err_in_tol=res_err,
                   residuals_equal_b1=same, ms=ms,
                   ms_without_residuals=bare_ms, plain_ms=plain_ms,
                   b1_ms_same_batch=b1_ms,
                   **occupancy(mega._paired_lib(),
                               "egnn_mega_paired_fwd", N, dtype))
        assert same, "B4's residuals are not B1's"
        print("kernel B4:", json.dumps(row), flush=True)
        rows.append(row)
        del args, out, ref, a1, xd, a1_ref, xd_ref, a1_b1, xd_b1
    return rows


def tail_g_inputs(e: int, f: int, dtype, seed: int, b: int = B):
    """B5's operands: B1's residuals on seeded inputs (indices at -1 and N
    on a few edges), a seeded node cotangent g [B, N, H+3] in the compute
    dtype: (src, dst, valid, ef, w2, wc1, small, a1, xd, g)."""
    from immunostruct_tpu_torch.ops.mega import edge_mega_fwd, valid_edges

    args = list(kernel_inputs(b, e, f, dtype, seed))
    args[0][:, 8:12] = -1
    args[1][:, 12:16] = N
    src, dst, mask, ef = args[:4]
    _, a1, xd = edge_mega_fwd(*args, residuals=True)
    g = torch.randn(b, N, H + 3, generator=torch.Generator().manual_seed(seed))
    return (src, dst, valid_edges(src, dst, mask, N), ef, *args[7:], a1, xd,
            g.to("cuda", dtype))


def b2_operands(src, dst, valid, ef, w2, wc1, small, a1, xd, g):
    """B2's operands from B5's, d_both = g[dst] gathered as 'hybrid' does."""
    from immunostruct_tpu_torch.ops.mega import _gather_rows

    d_both = _gather_rows(g, dst, valid).transpose(1, 2).contiguous()
    return ef, w2, wc1, small, a1, xd, d_both, valid


def check_tail_db_kernel() -> list:
    """B5a against its plain version and against B2 on the same inputs."""
    from immunostruct_tpu_torch.ops.mega import (
        tail_bwd, tail_bwd_db, tail_bwd_db_reference,
    )

    rows = []
    for b, e, f, name, dtype in TAIL_CASES:
        args = tail_g_inputs(e, f, dtype, seed=e + f + 3, b=b)
        db = args[1:]
        out = tail_bwd_db(*db)
        torch.cuda.synchronize()
        b2_args = b2_operands(*args)
        stats = tail_errors(out, tail_bwd_db_reference(*db), dtype, b2_args)
        b2 = tail_bwd(*b2_args)
        equal_b2 = all(torch.equal(g, h) for g, h in zip(out, b2))
        again = tail_bwd_db(*db)
        assert all(torch.equal(g, h) for g, h in zip(out, again)), \
            "B5a changed from one run to the next"
        ms, plain_ms = alternate_ms(
            lambda: tail_bwd_db_reference(*db),
            lambda: tail_bwd_db(*db))
        b2_ms = cuda_ms(lambda: tail_bwd(*b2_args))
        gather_b2_ms = cuda_ms(lambda: tail_bwd(*b2_operands(*args)))
        valid = args[2].sum().item()
        work = bound(tensor_bytes(*db, *out),
                     2 * valid * 6 * H * H, dtype)
        row = dict(B=b, E=e, F=f, dtype=name, **stats, **work,
                   smem_per_cta=tail_smem("egnn_tail_bwd_db", dtype),
                   equals_b2_bit_for_bit=equal_b2, ms=ms,
                   plain_ms=plain_ms, b2_ms=b2_ms,
                   gather_and_b2_ms=gather_b2_ms)
        print("kernel B5a:", json.dumps(row), flush=True)
        rows.append(row)
        del args, db, out, b2, b2_args, again
    return rows


def nodes_errors(got, ref, dtype) -> dict:
    """B5b's d_nodes [B, N, 2(H+3)] f32 against its plain version, per
    column over graphs and nodes: f32 |diff| <= 1e-5 * max|plain| + 1e-4 *
    |plain|; bf16 B2's d_cat bounds (TAIL_MAX_EDGE, TAIL_MEAN)."""
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    g, r = got.flatten(0, 1).T, ref.flatten(0, 1).T
    if dtype == torch.float32:
        assert ((g - r).abs() <= 1e-5 * r.abs().amax(1, keepdim=True)
                + 1e-4 * r.abs()).all()
        return dict(d_nodes_max_abs_err=(g - r).abs().max().item())
    stats = rel_stats(g, r)
    assert stats["max_rel"] <= TAIL_MAX_EDGE, stats
    assert stats["mean_rel"] <= TAIL_MEAN, stats
    return dict(d_nodes=stats, d_nodes_max_abs_err=(g - r).abs().max().item())


def check_tail_nodes_kernel() -> list:
    """B5b against its plain version, the same bits twice, and timed beside
    what it replaces on the 'hybrid' path (the gather, B2, two
    scatter_add_)."""
    from immunostruct_tpu_torch.ops.mega import (
        tail_bwd, tail_bwd_nodes, tail_bwd_nodes_reference,
    )

    def hybrid_glue(src, dst, valid, ef, w2, wc1, small, a1, xd, g):
        d_cat = tail_bwd(*b2_operands(src, dst, valid, ef, w2, wc1, small,
                                      a1, xd, g))[0]
        dcf = d_cat.transpose(1, 2).float()
        for idx in (src, dst):
            i = torch.where(valid, idx, 0).long()[..., None].expand(
                -1, -1, H + 3)
            torch.zeros(src.shape[0], N, H + 3,
                        device="cuda").scatter_add_(1, i, dcf)

    rows = []
    for b, e, f, name, dtype in TAIL_CASES:
        args = tail_g_inputs(e, f, dtype, seed=e + f + 4, b=b)
        out = tail_bwd_nodes(*args)
        torch.cuda.synchronize()
        ref = tail_bwd_nodes_reference(*args)
        stats = nodes_errors(out[0], ref[0], dtype)
        zeros = torch.zeros(1, 1, 1, dtype=dtype, device="cuda")
        stats.update(tail_errors((zeros, *out[1:]), (zeros, *ref[1:]),
                                 dtype, b2_operands(*args)))
        stats["max_abs_err"] = max(stats["max_abs_err"],
                                   stats["d_nodes_max_abs_err"])
        again = tail_bwd_nodes(*args)
        assert all(torch.equal(g, h) for g, h in zip(out, again)), \
            "B5b changed from one run to the next"
        ms, plain_ms = alternate_ms(
            lambda: tail_bwd_nodes_reference(*args),
            lambda: tail_bwd_nodes(*args))
        glue_ms = cuda_ms(lambda: hybrid_glue(*args))
        valid = args[2].sum().item()
        work = bound(tensor_bytes(*args, *out),
                     2 * valid * 6 * H * H, dtype)
        row = dict(B=b, E=e, F=f, dtype=name, **stats, **work, ms=ms,
                   smem_per_cta=tail_smem("egnn_tail_bwd_nodes", dtype),
                   plain_ms=plain_ms,
                   gather_b2_scatter_adds_ms=glue_ms)
        print("kernel B5b:", json.dumps(row), flush=True)
        rows.append(row)
        del args, out, ref, again
    return rows


def check_sweep(card: str) -> None:
    """Phase 14b: every kernel on every seeded input of its card tests,
    judged by kernel_checks' rule (the CPU's plain version on the inputs
    past the bound); a line a kernel; asserts that no input fails."""
    from immunostruct_tpu_torch.ops import kernel_checks as kc

    for kernel in kc.KERNELS:
        _, line = kc.sweep(kernel, yardstick="failing")
        failing = line.pop("failing_inputs")
        print(json.dumps(line), flush=True)
        print(f"sweep   [{card}]: {kernel}: {line['inputs']} inputs, "
              f"{line['failing']} failing, {line['over_bound']} past the "
              f"bound ({line['restated']} restated), worst "
              f"{line['worst']:.4f} of what the rule allows, "
              f"{line['wall_s']:.1f} s", flush=True)
        assert not failing, (kernel, failing)


def stack_layer_verdict(out, args, packed, dtype) -> dict:
    """Each layer of B6 against the plain version of that layer run from
    the kernel's own previous h and x (so that a flipped rounding does not
    carry into the next layer's check). bf16: kernel_checks' rule
    (stack_checks, judge), the plain version run on the CPU as its
    yardstick where a unit is past its bound, as the sweep and the card
    tests judge it; f32: F32_TOL. Asserts it; returns the largest |diff|
    and, in bf16, the verdict."""
    from immunostruct_tpu_torch.ops import kernel_checks as kc
    from immunostruct_tpu_torch.ops.stack import stack_fwd_reference

    h, x, hs, xs, aggs, a1s, xds = out
    assert torch.equal(h, hs[:, -1]) and torch.equal(x, xs[:, -1])
    src, dst, mask, ef = args[:4]
    err = 0.0
    for layer, weights in enumerate(packed):
        ref = stack_fwd_reference(src, dst, mask, ef,
                                  *kc._layer_inputs(out, args, layer),
                                  [weights])
        got = [t[:, layer] for t in (hs, xs, aggs, a1s, xds)]
        want = [t[:, 0] for t in ref[2:]]
        assert all(torch.isfinite(g).all() for g in got)
        err = max(err, *((g.float() - w.float()).abs().max().item()
                         for g, w in zip(got, want)))
        if dtype == torch.float32:
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **F32_TOL)
    if dtype == torch.float32:
        return dict(max_abs_err=err)
    verdict = kc.judge(kc.stack_checks(out, args, packed))
    if not verdict["ok"]:               # the CPU's spread, where it is past
        verdict = kc.judge(kc.stack_checks(out, args, packed, cpu=True))
    assert verdict["ok"], verdict["failing"]
    return dict(max_abs_err=err, rule_worst=verdict["worst"],
                worst_vs_bound=verdict["worst_vs_bound"],
                cpu_worst=verdict["cpu_worst"], restated=verdict["restated"])


def check_stack_kernel() -> list:
    """B6 against its plain version, layer by layer, timed beside it and
    beside the per-layer path's forward with no gradient, at B=128 and, in
    bf16 at E=2560, B=1 (one graph, one CTA); the same bits twice; its
    shared memory a CTA, CTAs an SM and the compiler's readings."""
    from immunostruct_tpu_torch.ops import _build
    from immunostruct_tpu_torch.ops import kernel_checks as kc
    from immunostruct_tpu_torch.ops.egnn import egnn_stack
    from immunostruct_tpu_torch.ops.mega import valid_edges
    from immunostruct_tpu_torch.ops.stack import (
        _lib, stack_fwd, stack_fwd_reference,
    )

    ptxas = _build.ptxas_readings("egnn_stack_fwd")
    print("kernel B6 ptxas:", json.dumps(ptxas), flush=True)
    rows = []
    cases = [(B, e, name, dtype) for e in EDGE_COUNTS
             for name, dtype in DTYPES] + [(1, EDGE_COUNTS[0], "bfloat16",
                                            torch.bfloat16)]
    for b, e, name, dtype in cases:
        args, packed = kc.stack_args(b, e, dtype, "cuda", seed=e + 6)
        out = stack_fwd(*args, packed)
        again = stack_fwd(*args, packed)
        torch.cuda.synchronize()
        assert all(torch.equal(a, z) for a, z in zip(out, again))
        del again
        stats = stack_layer_verdict(out, args, packed, dtype)
        ms, plain_ms = alternate_ms(
            lambda: stack_fwd_reference(*args, packed),
            lambda: stack_fwd(*args, packed))
        bare_ms = cuda_ms(lambda: stack_fwd(*args, packed,
                                            residuals=False))
        dev_ms = device_ms(lambda: stack_fwd(*args, packed))
        layers = egnn_stack(5, 20, H, generator=torch.Generator()
                            .manual_seed(e + 6), device="cuda")

        def per_layer():
            from immunostruct_tpu_torch.ops.egnn import egnn_stack_apply

            with torch.no_grad():
                egnn_stack_apply(layers, args[4], args[5], *args[:2],
                                 args[3], args[2], "mega")

        hybrid_ms = cuda_ms(per_layer)
        valid = valid_edges(*args[:3], N).sum().item()
        flops = 0
        for weights in packed:
            f = weights[0].shape[0] // 2
            flops += (2 * b * N * f * 2 * H + 2 * valid * 2 * H * H
                      + 2 * b * N * (f + H) * H + 2 * b * N * H * H)
        work = bound(tensor_bytes(*args, *(t for w in packed for t in w),
                                  *out), flops, dtype)
        bf16 = int(dtype == torch.bfloat16)
        kernel = ("egnn_stack_fwd_mma_kernel" if bf16
                  else "egnn_stack_fwd_kernel<f32>")
        row = dict(B=b, E=e, F="20, then 64", dtype=name, **stats,
                   **work, ms=ms, device_ms=dev_ms,
                   ms_without_residuals=bare_ms,
                   plain_ms=plain_ms, same_bits=True,
                   per_layer_forward_no_grad_ms=hybrid_ms,
                   smem_per_cta=_lib().egnn_stack_fwd_smem_bytes(
                       N, H, bf16),
                   ctas_per_sm=_lib().egnn_stack_fwd_ctas_per_sm(
                       N, H, bf16), ptxas=ptxas.get(kernel))
        print("kernel B6:", json.dumps(row), flush=True)
        rows.append(row)
        del args, packed, out, layers
    return rows


def check_variant_first_steps() -> list:
    """Each variant's first full-width HybridModelv2 step (bf16) against
    'scatter' on a mirror-paired batch, as phase 16 holds 'mega''s."""
    from immunostruct_tpu_torch.data.synthetic import build_batch

    rows = []
    for e in EDGE_COUNTS:
        batch = build_batch(B, N, e, L, paired=True, device="cuda")
        for v in ("dboth", "inkernel", "paired", "stack"):
            first = first_step_vs_scatter(batch, "mega", v)
            row = dict(E=e, variant=v, **first)
            print("variant first step:", json.dumps(row), flush=True)
            rows.append(row)
    return rows


def check_race() -> tuple:
    """The fifth slice's main path: cli.race_kernel_variants in-process at B=128,
    E=2560 and 1408, --paired-batch, all six variants. Each variant's
    launches per step are the ones VARIANT_LAUNCHES names, and its loss
    falls."""
    from immunostruct_tpu_torch.cli import race_kernel_variants as race

    rows = []
    total = (0,) * 11
    for e in EDGE_COUNTS:
        reset_counts()                  # every count to 0: the race starts
        out = race.main(["--edges", str(e), "--batch", str(B),
                         "--paired-batch", "--windows", str(RACE_WINDOWS),
                         "--steps", str(RACE_STEPS), "--burnin",
                         str(RACE_BURNIN), "--device", "cuda"])
        counts = read_counts()          # read just after it
        total = tuple(a + c for a, c in zip(total, counts))
        assert list(out) == list(VARIANT_LAUNCHES), list(out)
        for v, r in out.items():
            assert r["launches_per_step"] == VARIANT_LAUNCHES[v], (v, r)
            assert all(t == t and abs(t) < float("inf")
                       for t in (r["loss0"], r["min_loss"],
                                 *r["windows_loss"])), (v, r)
            # the loss falls: on one fixed batch every variant's loss, the
            # 'fused' control's too, spikes now and then and recovers
            assert r["min_loss"] < r["loss0"], (v, r)
        rows.append(dict(E=e, launches=counts, race=out))
        print(f"race E={e}:", json.dumps(rows[-1]), flush=True)
    # the path's kernels: every one but B8's ran
    assert all(total[i] > 0 for i in (0, 1, 2, 3, 6, 7, 8, 9)), total
    return rows, total


def check_variant_serving(scorer) -> list:
    """One B=128 forward with no gradient under 'stack' and 'paired' (the
    served model, a mirror-paired batch at E=2560): probabilities within
    PROB_ATOL of 'scatter', the same bits twice, the variant's kernel alone
    launched."""
    from immunostruct_tpu_torch.data.synthetic import build_batch
    from immunostruct_tpu_torch.models.trunk import model_apply

    batch = build_batch(B, N, EDGE_COUNTS[0], L, paired=True, device="cuda")

    def probs(aggregation, variant):
        with torch.inference_mode():
            out = model_apply(scorer.model, batch.graph, batch.seq_onehot,
                              batch.props, generator=scorer.generator(),
                              deterministic=True, aggregation=aggregation,
                              compute_dtype=scorer.compute_dtype,
                              mega_variant=variant)
            return torch.sigmoid(out.logits.reshape(-1)).double().cpu()

    def forward_ms(aggregation, variant):
        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            probs(aggregation, variant)     # ends in a copy to the host
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls[1:])

    want = probs("scatter", "hybrid")
    rows = []
    for variant, kernel in (("stack", 9), ("paired", 6)):
        before = read_counts()
        got = probs("mega", variant)
        launched = tuple(a - z for a, z in zip(read_counts(), before))
        layers = 1 if variant == "stack" else 6
        assert launched == tuple(layers if i == kernel else 0
                                 for i in range(11)), (variant, launched)
        assert torch.equal(probs("mega", variant), got), variant
        err = (got - want).abs().max().item()
        assert torch.isfinite(got).all() and err <= PROB_ATOL, (variant, err)
        row = dict(variant=variant, launches=launched,
                   max_abs_prob_err_vs_scatter=err,
                   median_forward_ms=forward_ms("mega", variant),
                   median_forward_ms_hybrid=forward_ms("mega", "hybrid"))
        print("served variant:", json.dumps(row), flush=True)
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# the forward-only paths: B7, 'onehot'/'onehot_remat', batch inference
# --------------------------------------------------------------------------

def b7_inputs(b: int, e: int, f: int, dtype, seed: int):
    """B7's operands at the main path's shapes: a seeded EGNN layer (H=64)
    and seeded inputs with 10% of the edges masked, self-loops, and
    unmasked edges whose src or dst is -1 or N."""
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer

    src, dst, mask, _, h, x = kernel_inputs(b, e, f, dtype, seed)[:6]
    src[:, 8:10], src[:, 10:12] = -1, N
    dst[:, 12:14], dst[:, 14:16] = -1, N
    mask[:, 8:16] = True
    layer = EGNNLayer(f, H, H, generator=torch.Generator().manual_seed(seed),
                      device="cuda")
    return layer, (h, x, src, dst, mask)


def b7_errors(out, ref, dtype) -> dict:
    """h' and x' against the plain version: f32 within F32_TOL; bf16 per
    column (over graphs and nodes) max|diff| within one bf16 step at the
    column's largest |plain| (phase 14's form: one flipped rounding at a
    value just above a power of two is up to 2^-7 of it, over
    BF16_COL_MAX) and mean|diff| <= BF16_COL_MEAN * mean|plain|. The card
    tests' ten mutant kernels, each without one of B7's rounding points,
    fail these bounds (tests/test_torch_port_cuda.py)."""
    row = dict(max_abs_err=max((o.float() - r.float()).abs().max().item()
                               for o, r in zip(out, ref)))
    for name, o, r in zip(("h", "x"), out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        assert torch.isfinite(o).all(), name
        if dtype == torch.float32:
            torch.testing.assert_close(o, r, **F32_TOL)
            continue
        g, w = o.float().flatten(0, 1), r.float().flatten(0, 1)
        diff, mag = (g - w).abs(), w.abs()
        top = mag.amax(0).clamp_min(torch.finfo(torch.float32).tiny)
        steps = (diff.amax(0) / torch.exp2(torch.floor(torch.log2(top))
                                           - 7)).max().item()
        rel = bf16_errors(o, r)
        assert steps <= 1.0, (name, steps)
        assert rel["col_mean_rel"] <= BF16_COL_MEAN, (name, rel)
        row.update({f"{name}_{k}": v for k, v in rel.items()},
                   **{f"{name}_col_max_steps": steps})
    return row


def check_b7_kernel() -> list:
    """B7-check: B7 against its plain version at phase 4's shapes and, in
    bf16 at E=2560, F=64, at B=1 and 8 (a graph over a cluster of CTAs),
    the same bits twice, kernel, plain and bound times; the cluster size,
    shared memory a CTA, CTAs an SM, clusters the card holds at once and
    the compiler's readings."""
    from immunostruct_tpu_torch.ops import _build
    from immunostruct_tpu_torch.ops.fused_layer import (
        _lib, fused_egnn_layer, fused_egnn_layer_reference,
        layer_cluster_size,
    )

    ptxas = _build.ptxas_readings("egnn_layer_fwd")
    print("kernel B7 ptxas:", json.dumps(ptxas), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    cases = [(B, e, f, name, dtype) for e in EDGE_COUNTS for f in (20, 64)
             for name, dtype in DTYPES] + [
        (b, EDGE_COUNTS[0], 64, "bfloat16", torch.bfloat16) for b in (1, 8)]
    with torch.no_grad():
        for b, e, f, name, dtype in cases:
            layer, args = b7_inputs(b, e, f, dtype, seed=e + f + 7)
            out = fused_egnn_layer(layer, *args)
            again = fused_egnn_layer(layer, *args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, z) for a, z in zip(out, again))
            ref = fused_egnn_layer_reference(layer, *args)
            err = b7_errors(out, ref, dtype)
            ms, plain_ms = alternate_ms(
                lambda: fused_egnn_layer_reference(layer, *args),
                lambda: fused_egnn_layer(layer, *args))
            dev_ms = device_ms(lambda: fused_egnn_layer(layer, *args))
            h, x, src, dst, mask = args
            summed = (mask & (dst >= 0) & (dst < N)).sum().item()
            # the products this run's edges need (those summed at a
            # dst: the others touch no output), then the node MLP
            flops = (2 * summed * (2 * f * H + 2 * H * H + H)
                     + 2 * b * N * ((f + H) * H + H * H))
            weights = _lib().egnn_layer_fwd_weight_count(f, H)
            nbytes = (tensor_bytes(h, x, src, dst, mask, *out)
                      + weights * h.element_size())
            bf16 = int(dtype == torch.bfloat16)
            cluster = layer_cluster_size(e, b, sms) if bf16 else 1
            kernel = ("egnn_layer_fwd_mma_kernel<bf16>" if bf16
                      else "egnn_layer_fwd_kernel<f32>")
            occupancy = dict(
                smem_per_cta=_lib().egnn_layer_fwd_smem_bytes(
                    N, f, H, bf16))
            if bf16:
                occupancy.update(
                    ctas_per_sm=_lib().egnn_layer_fwd_ctas_per_sm(
                        N, f, 1),
                    clusters_at_once=_lib()
                    .egnn_layer_fwd_max_clusters(N, f, cluster))
            row = dict(B=b, E=e, F=f, dtype=name, **err,
                       **bound(nbytes, flops, dtype), same_bits=True,
                       edges_summed=summed, ms=ms, device_ms=dev_ms,
                       plain_ms=plain_ms, cluster=cluster,
                       **occupancy, ptxas=ptxas.get(kernel))
            print("kernel B7:", json.dumps(row), flush=True)
            rows.append(row)
            del layer, args, out, again, ref
    return rows


def fused_stack_scorer(scorer):
    """The served model of phase 15 behind a Scorer with fused_stack."""
    from immunostruct_tpu_torch.serving import Scorer

    return Scorer(scorer.model, device=scorer.device,
                  compute_dtype=scorer.compute_dtype, aggregation="auto",
                  seed=scorer.seed, fused_stack=True)


SAME_BITS_B, SAME_BITS_STEPS = 16, 3


def check_same_bits() -> list:
    """Same seed, same bits: full-width HybridModelv2 (bf16 over f32 master
    weights, Adam) from one seed, SAME_BITS_STEPS steps on one mirror-paired
    batch (B=SAME_BITS_B, E=2560), trained twice from fresh state under
    every aggregation ('mega' under each variant, 'fused', 'pallas',
    'onehot', 'auto'): the losses, every parameter and every Adam moment
    equal bit for bit. 'scatter' (index_add_, whose atomics sum in no fixed
    order: the reference algorithm's baseline) is read, not asserted."""
    from immunostruct_tpu_torch.data.synthetic import build_batch
    from immunostruct_tpu_torch.ops.mega import MEGA_VARIANTS

    batch = build_batch(SAME_BITS_B, N, EDGE_COUNTS[0], L, paired=True,
                        device="cuda")
    paths = [("mega", v) for v in MEGA_VARIANTS] + [
        (agg, "hybrid") for agg in ("fused", "pallas", "onehot", "auto",
                                    "scatter")]
    rows = []
    for agg, variant in paths:
        runs = []
        for _ in range(2):
            trainer, state = make_trainer("HybridModelv2", agg,
                                          mega_variant=variant)
            losses = []
            for _ in range(SAME_BITS_STEPS):
                state, loss = trainer.train_step(state, batch, seed=0)
                losses.append(loss.detach().clone())
            torch.cuda.synchronize()
            params = list(state.model.parameters())
            runs.append((losses, [p.detach().clone() for p in params],
                         [state.optimizer.state[p][k].clone() for p in params
                          for k in ("exp_avg", "exp_avg_sq")]))
            del trainer, state, params
        differ = sum(int((a != z).sum()) for part in zip(*runs)
                     for a, z in zip(*part))
        row = dict(aggregation=agg, mega_variant=variant, B=SAME_BITS_B,
                   E=EDGE_COUNTS[0], steps=SAME_BITS_STEPS,
                   losses=[float(v) for v in runs[0][0]],
                   entries_that_differ=differ)
        print("same bits:", json.dumps(row), flush=True)
        if agg != "scatter":
            assert differ == 0, row
        rows.append(row)
    return rows


def check_onehot_training() -> list:
    """The first full-width train step under 'onehot' and 'onehot_remat'
    against 'scatter' (phase 16's bounds) at E=2560, and the peak device
    memory of one step under each and under 'mega'."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    batch = random_sample_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                device="cuda")
    row = dict(E=EDGE_COUNTS[0])
    for agg in ("onehot", "onehot_remat"):
        first = first_step_vs_scatter(batch, agg)
        row[agg] = first
        print(f"{agg} first step E={EDGE_COUNTS[0]}:", json.dumps(first),
              flush=True)
    peak = {}
    for agg in ("onehot", "onehot_remat", "mega"):
        trainer, state = make_trainer("HybridModelv2", agg)
        trainer.train_step(state, batch, seed=0)    # optimizer state made
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        t0 = time.perf_counter()
        trainer.train_step(state, batch, seed=0)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launched = tuple(a - z for a, z in zip(read_counts(), before))
        want = (6, 6, 0, 0, 12) + (0,) * 6 if agg == "mega" else (0,) * 11
        assert launched == want, (agg, launched)
        peak[agg] = dict(max_memory_allocated_bytes=
                         torch.cuda.max_memory_allocated(), step_ms=step_ms)
        del trainer, state
    assert (peak["onehot_remat"]["max_memory_allocated_bytes"]
            < peak["onehot"]["max_memory_allocated_bytes"]), peak
    row["peak_memory"] = peak
    print("onehot training:", json.dumps(row), flush=True)
    return row


def check_batch_inference(entry: dict, cancer: dict, tmp: str) -> dict:
    """cli.infer_IEDB_or_Cancer in-process on phase 19's finetune
    checkpoint, under --aggregation auto (6 B1 launches per batch) and
    onehot (no kernel): 51 test rows of three columns each, the same rows
    and labels, probabilities within PROB_ATOL of each other; then
    --comparative on phase 21's checkpoint."""
    from immunostruct_tpu_torch.cli import infer_IEDB_or_Cancer as cli

    def finetune(save_dir):
        return os.path.join(save_dir, next(
            f for f in sorted(os.listdir(save_dir))
            if f.endswith("_finetune.ckpt")))

    def run(args, aggregation, out):
        reset_counts()                  # every count to 0: inference starts
        t0 = time.perf_counter()
        stats = cli.main(args + ["--aggregation", aggregation, "--output",
                                 out, "--compute-dtype", "bfloat16",
                                 "--batch-size", str(B), "--device", "cuda",
                                 "--seed", "1", "--full-sequence"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()          # read just after it
        with open(out) as fh:
            rows = [line.rstrip("\n").split("\t") for line in fh]
        assert all(len(r) == 3 for r in rows), rows[:2]
        probs = np.array([float(r[0]) for r in rows])
        assert np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()
        assert len(stats["predicted_probs"]) == len(rows)
        return rows, probs, counts, wall_s

    out = {}
    for label, args, model in (
            ("IEDB", entry["infer_args"], "HybridModelv2"),
            ("comparative", cancer["infer_args"] + ["--comparative"],
             "HybridModelv2_Comparative")):
        args = ["--model", model, "--checkpoint",
                finetune(entry["save_dir"] if label == "IEDB"
                         else cancer["save_dir"])] + args
        auto = run(args, "auto", os.path.join(tmp, f"preds_{label}_auto.txt"))
        onehot = run(args, "onehot",
                     os.path.join(tmp, f"preds_{label}_onehot.txt"))
        batches = -(-len(auto[0]) // B)
        per = 12 if label == "comparative" else 6     # twins: two passes
        assert auto[2] == (per * batches,) + (0,) * 10, auto[2]
        assert onehot[2] == (0,) * 11, onehot[2]
        assert [r[1:] for r in auto[0]] == [r[1:] for r in onehot[0]]
        err = float(np.abs(auto[1] - onehot[1]).max())
        assert err <= PROB_ATOL, (label, err)
        if label == "IEDB":
            assert len(auto[0]) == int(CLI_SAMPLES * 0.1), len(auto[0])
        row = dict(rows=len(auto[0]), batches=batches,
                   launches_auto=auto[2], launches_onehot=onehot[2],
                   max_abs_prob_diff=err, wall_s_auto=auto[3],
                   wall_s_onehot=onehot[3])
        print(f"batch inference ({label}):", json.dumps(row), flush=True)
        out[label] = row
    return out


# --------------------------------------------------------------------------
# the twelfth slice: PDBs -> featurized corpus -> curriculum -> clinical
# --------------------------------------------------------------------------

class ClinicalCorpus:
    """synthetic_clinical_corpus built by a process of its own, started
    (``start``) after the kernel phases, whose timings its host work would
    disturb, so that it overlaps the serving and training phases."""

    def __init__(self, root: str):
        self.root = root
        self.proc = None
        self.build_s = None

    def start(self) -> None:
        code = ("import sys, time; sys.path.insert(0, sys.argv[1]); "
                "from immunostruct_tpu_torch.data.synthetic import "
                "synthetic_clinical_corpus as make; t0 = time.perf_counter(); "
                "make(sys.argv[2], num_rows=int(sys.argv[3]), "
                "num_patients=int(sys.argv[4]), hla_len=275, seed=5); "
                "print(time.perf_counter() - t0)")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, ROOT, self.root, str(CLINICAL_ROWS),
             str(CLINICAL_PATIENTS)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def paths(self) -> tuple:
        """(graph_dir, seq_path, clin_path), once the corpus is written."""
        if self.build_s is None:
            out, err = self.proc.communicate()
            assert self.proc.returncode == 0, err
            self.build_s = float(out.split()[-1])
            print(f"clinical corpus: {CLINICAL_ROWS} rows, "
                  f"{CLINICAL_PATIENTS} patients, built in "
                  f"{self.build_s:.1f} s (in the background)", flush=True)
        return (os.path.join(self.root, "graph_pyg_Clinical"),
                os.path.join(self.root, "clinical_seq.tsv"),
                os.path.join(self.root, "clinical_outcomes.tsv"))

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def _captured(fn, argv) -> tuple:
    """fn(argv)'s result and its printed lines, which are printed too."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    print(buf.getvalue(), end="", flush=True)
    return result, buf.getvalue().splitlines()


def check_featurize(tmp: str, entry: dict) -> dict:
    """Phase 22: the IEDB corpus of phase 19 written back as CA PDBs (one a
    graph, named by its join key; HLA chain A 1-275, the peptide chain C
    after it; helix CAs), one with no CA in the subgraph's positions and one
    whose residue number does not parse, featurized by cli.featurize on the
    native library built from native/featurizer.cc and on the numpy path,
    as the JAX package's paths treat them: the same graphs bit for bit, a
    graph of no nodes for the first on both paths and for the second on the
    native path (its parser reads the number as residue 0, which the
    subgraph's filter drops), the second in the numpy path's error_log.txt
    alone; then cli.validate_data joins every table row."""
    from immunostruct_tpu_torch.cli import featurize, validate_data
    from immunostruct_tpu_torch.data.synthetic import write_corpus_pdbs
    from immunostruct_tpu_torch.featurize import native

    graph_dir, props, hla = entry["corpus"]
    pdb_dir = os.path.join(tmp, "pdb")
    t0 = time.perf_counter()
    paths = write_corpus_pdbs(graph_dir, pdb_dir, hla_len=275)
    with open(os.path.join(pdb_dir, "brokenImmunoZ.pdb"), "w") as fh:
        fh.write("ATOM      1  CA  GLY A  ab     0.000   0.000   0.000  "
                 "1.00\n")
    with open(os.path.join(pdb_dir, "farImmunoY.pdb"), "w") as fh:
        fh.write("ATOM      1  CA  GLY A 200       0.000   0.000   0.000  "
                 "1.00\nATOM      2  CA  ALA A 201       3.800   0.000   "
                 "0.000  1.00\n")
    write_s = time.perf_counter() - t0
    assert len(paths) == CLI_SAMPLES
    t0 = time.perf_counter()
    native.build()                      # the host's C++ compiler
    build_s = time.perf_counter() - t0

    row = dict(structures=len(paths), write_pdbs_s=write_s,
               native_build_s=build_s)
    outs = {}
    for label, extra in (("native", []), ("numpy", ["--no-native"])):
        outs[label] = os.path.join(tmp, f"featurized_{label}")
        t0 = time.perf_counter()
        written, lines = _captured(featurize.main, [
            "--alphafold-folder", pdb_dir, "--save-folder", outs[label],
            *extra])
        wall_s = time.perf_counter() - t0
        graphs = CLI_SAMPLES + (2 if label == "native" else 1)
        assert len(written) == graphs, len(written)
        assert lines[-1].startswith(f"featurized {graphs} structures")
        assert lines[-1].endswith(f"native={label == 'native'})"), lines[-1]
        log_path = os.path.join(outs[label], "error_log.txt")
        if label == "native":
            assert not os.path.exists(log_path)
        else:
            with open(log_path) as fh:
                log = fh.read().splitlines()
            assert len(log) == 1 and "brokenImmunoZ" in log[0], log
        row[label] = dict(wall_s=wall_s,
                          structures_per_s=CLI_SAMPLES / wall_s,
                          printed=lines[-1])
    files = sorted(f for f in os.listdir(outs["numpy"]) if f.endswith(".npz"))
    assert files == sorted(f for f in os.listdir(outs["native"])
                           if f.endswith(".npz") and f != "brokenImmunoZ.npz")
    assert len(files) == CLI_SAMPLES + 1
    for out in outs.values():
        with np.load(os.path.join(out, "farImmunoY.npz")) as a:
            assert a["x"].shape == (0, 22) and a["edge_index"].shape == (2, 0)
    files.remove("farImmunoY.npz")
    nodes, arcs = [], []
    for f in files:
        with np.load(os.path.join(outs["native"], f)) as a, \
                np.load(os.path.join(outs["numpy"], f)) as b:
            assert str(a["name"]) == str(b["name"]), f
            for k in ("x", "coords", "edge_index"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
                    (f, k)
            nodes.append(a["x"].shape[0])
            arcs.append(a["edge_index"].shape[1])
    rc, lines = _captured(validate_data.main, [
        "--graph-dir", outs["native"], "--property-path", props,
        "--hla-path", hla])
    assert rc == 0
    assert any(f"join coverage: {CLI_SAMPLES}/{CLI_SAMPLES} table rows have "
               "a graph (100.0%)" in line for line in lines), lines
    row.update(graph_dir=outs["native"], nodes=[min(nodes), max(nodes)],
               arcs=[min(arcs), max(arcs)])
    print("featurize:", json.dumps(row), flush=True)
    return row


CURRICULUM_STAGES = ("PropIEDB", "ImmunoIEDB", "PropCancer", "ImmunoCancer")


def check_curriculum(tmp: str, featurized: dict, entry: dict,
                     cancer: dict) -> dict:
    """Phase 23: cli.train_curriculum, the four comparative stages under
    --aggregation mega at full width, bf16, batch 128, 2 epochs a stage,
    the IEDB stages on phase 22's featurized graphs and the cancer/WT
    stages on phase 21's pairs (the last stage cycled to 64 batches an
    epoch). Returns its row and the operands of B1, B2 and B8's scatter,
    the first call of each (kernel, shape, dtype)."""
    from immunostruct_tpu_torch.cli import train_curriculum as cli
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.ops import mega, segment
    from immunostruct_tpu_torch.utils.checkpoint import load_checkpoint

    _, props, hla = entry["corpus"]
    save_dir = os.path.join(tmp, "curriculum_ckpt")
    stages, inferences = [], []
    real_train, real_infer = cli.train_model, cli.inference

    def train_model(config, model, train_pipe, *args, **kw):
        before = read_counts()
        model, history = real_train(config, model, train_pipe, *args, **kw)
        graphs = train_pipe.ds.graphs
        stages.append(dict(stage=kw["stage"], resume_tag=kw["resume_tag"],
                           comparative=hasattr(train_pipe, "wt"),
                           steps_per_epoch=len(train_pipe), history=history,
                           launches=[a - z for a, z in zip(read_counts(),
                                                           before)],
                           N=graphs.max_nodes, E=graphs.max_edges))
        return model, history

    def inference(*args, **kw):
        before = read_counts()
        stats = real_infer(*args, **kw)
        inferences.append([a - z for a, z in zip(read_counts(), before)])
        return stats

    # the helpers that check the operands of B1 (_fwd_operands), B2
    # (_tail_checks) and B8's scatter (_scatter_launch) keep copies of the
    # first operands of each shape; the wrappers that call them count the
    # launches as before
    operands = {}
    real_fwd, real_tail = mega._fwd_operands, mega._tail_checks
    real_scatter = segment._scatter_launch

    def keep(key, args):
        if key not in operands:
            with torch.inference_mode(False):
                operands[key] = tuple(
                    t.detach().clone() if torch.is_tensor(t) else t
                    for t in args)

    def fwd_operands(name, args, residuals):
        if name == "edge_mega":
            keep(("B1", *args[4].shape, args[0].shape[1], args[4].dtype),
                 args)
        return real_fwd(name, args, residuals)

    def tail_checks(name, lib_fn, entry, ef, w2, wc1, small, a1, xd, valid,
                    extra):
        if name == "tail_bwd":
            keep(("B2", *a1.shape, a1.dtype),
                 (ef, w2, wc1, small, a1, xd, extra["d_both"][0], valid))
        return real_tail(name, lib_fn, entry, ef, w2, wc1, small, a1, xd,
                         valid, extra)

    def scatter(*args):
        keep(("scatter", *args[2].shape, args[2].dtype), args)
        return real_scatter(*args)

    cli.train_model, cli.inference = train_model, inference
    mega._fwd_operands, mega._tail_checks = fwd_operands, tail_checks
    segment._scatter_launch = scatter
    try:
        reset_counts()                  # every count to 0: the curriculum
        t0 = time.perf_counter()
        train_stats, test_stats = cli.main([
            "--stages", ",".join(CURRICULUM_STAGES), "--comparative",
            "--model", "HybridModelv2_Comparative", "--full-sequence",
            "--sequence-loss", "--aggregation", "mega",
            "--compute-dtype", "bfloat16", "--batch-size", str(B),
            "--num-epochs", str(CLI_EPOCHS), "--coeff-contrastive", "0.1",
            "--min-finetuning-batches", str(MIN_FINETUNING_BATCHES),
            "--device", "cuda", "--seed", "1", "--model-save-dir", save_dir,
            "--graph-dir-IEDB", featurized["graph_dir"],
            "--property-path-IEDB", props, "--hla-path", hla,
            *cancer["infer_args"][:8]])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()          # read just after it
    finally:
        cli.train_model, cli.inference = real_train, real_infer
        mega._fwd_operands, mega._tail_checks = real_fwd, real_tail
        segment._scatter_launch = real_scatter

    assert [(s["stage"], s["comparative"], s["resume_tag"]) for s in stages] \
        == [("pretrain", False, "stage1"), ("pretrain", False, "stage2"),
            ("pretrain", True, "stage3"), ("finetune", True, "stage4")], stages
    assert stages[3]["steps_per_epoch"] == MIN_FINETUNING_BATCHES, stages[3]
    for s in stages:
        h = s["history"]
        assert len(h["train_loss"]) == CLI_EPOCHS, h
        assert all(v == v and abs(v) < float("inf")
                   for v in h["train_loss"] + h["val_loss"]), h
        b1, b2, b8s = s["launches"][0], s["launches"][1], s["launches"][4]
        steps = s["steps_per_epoch"] * CLI_EPOCHS
        twins = 2 if s["comparative"] else 1
        # a train step: B2 once a layer a twin, B8's scatter twice (the
        # node sums of the backward), B1 once a layer a twin (and in every
        # validation forward)
        assert b2 == 6 * twins * steps and b8s == 2 * b2, s
        assert b1 >= b2 and b1 % 6 == 0, s
        assert sum(s["launches"]) == b1 + b2 + b8s, s
    assert len(inferences) == 2, inferences
    for launched in inferences:
        assert launched[0] > 0 and sum(launched) == launched[0], launched
    assert sum(counts) == counts[0] + counts[1] + counts[4], counts
    for stats in (train_stats, test_stats):
        assert len(stats) == METRIC_KEYS, sorted(stats)
    assert test_stats["optimal_threshold"] == \
        train_stats["optimal_threshold"]
    ckpts = sorted(f for f in os.listdir(save_dir) if f.endswith(".ckpt"))
    assert [c.rsplit("_", 1)[1] for c in ckpts] == ["finetune.ckpt",
                                                     "pretrain.ckpt"], ckpts
    for c in ckpts:
        path = os.path.join(save_dir, c)
        with np.load(path) as z:
            vae_dim = z["['vae']['fc1']['w']"].shape[0]
        _, fresh = build_model("HybridModelv2_Comparative", vae_dim,
                               torch.Generator().manual_seed(0),
                               use_wt_for_downstream=False, device="cuda")
        load_checkpoint(path, fresh, verbose=False)
    epochs = []
    for name, s in zip(CURRICULUM_STAGES, stages):
        h = s["history"]
        per = 2 if s["comparative"] else 1      # pMHCs per sample (twins)
        for i, (dt, n) in enumerate(zip(h["epoch_time"],
                                        h["train_samples"])):
            epochs.append(dict(stage=name, epoch=i + 1, epoch_s=dt,
                               steps=s["steps_per_epoch"], train_samples=n,
                               pmhc_per_s=per * n / dt,
                               train_loss=h["train_loss"][i],
                               val_loss=h["val_loss"][i]))
    row = dict(save_dir=save_dir,
               finetune=os.path.join(save_dir, ckpts[0]), wall_s=wall_s,
               N_E_by_stage=[[s["N"], s["E"]] for s in stages],
               launches=counts,
               launches_by_stage=[s["launches"] for s in stages],
               launches_inference=inferences, epochs=epochs,
               train_roc_auc=train_stats["roc_auc"],
               test_roc_auc=test_stats["roc_auc"],
               threshold=train_stats["optimal_threshold"],
               kernel_shapes=sorted([k[0], *k[1:-1]] for k in operands))
    print("curriculum:", json.dumps(row), flush=True)
    return row, operands


def check_curriculum_kernels(operands: dict) -> tuple:
    """B1, B2 and B8's scatter against their plain versions on the operands
    the curriculum gave them, the first call of each (kernel, shape,
    dtype): B1 as in phase 4 and B2 as in phase 5, each as the curriculum
    ran it (bf16) and cast to f32; the scatter as in phase 9. Returns
    (B1 rows, B2 rows, scatter rows)."""
    fwd, tail, scatter = [], [], []
    for key in sorted(operands, key=str):
        kind, args = key[0], operands[key]
        if kind == "scatter":
            scatter.append(check_scatter_case(*args, "curriculum"))
            continue
        # the tensors in the compute dtype: B1's ef, h, x; B2's ef, a1, xd,
        # d_both (the packed weights and the masks stay as they are)
        cast_at = (3, 4, 5) if kind == "B1" else (0, 4, 5, 6)
        for dtype in (torch.float32, torch.bfloat16):
            cast = tuple(t.to(dtype) if i in cast_at else t
                         for i, t in enumerate(args))
            if kind == "B1":
                fwd.append(check_fwd_case(cast, "curriculum"))
            else:
                tail.append(check_tail_case(cast, "curriculum"))
    assert fwd and tail and scatter, sorted(operands, key=str)
    return fwd, tail, scatter


def check_clinical(tmp: str, clinical: tuple, curriculum: dict) -> dict:
    """Phase 24: cli.infer_clinical_only on phase 23's finetune checkpoint
    under --aggregation mega (twice) and scatter, bf16, batch 128, on the
    clinical cohort: 6 B1 launches a batch under 'mega' and no other, the
    same bits twice, the valid rows within PROB_ATOL of 'scatter', the
    invalid rows NaN and out of the loads, the p-values in [0, 1] and
    clinical_pvalues' of the card's probabilities."""
    from immunostruct_tpu_torch.cli import infer_clinical_only as cli
    from immunostruct_tpu_torch.data.tables import read_rows
    from immunostruct_tpu_torch.procedures import clinical as survival

    graph_dir, seq_path, clin_path = clinical
    real_score = cli.inference_clinical_only
    scoring = []

    def inference_clinical_only(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_score(*args, **kw)
        torch.cuda.synchronize()
        scoring.append(time.perf_counter() - t0)
        return out

    runs = {}
    cli.inference_clinical_only = inference_clinical_only
    try:
        for label, aggregation in (("mega", "mega"), ("mega again", "mega"),
                                   ("scatter", "scatter")):
            reset_counts()              # every count to 0: scoring starts
            t0 = time.perf_counter()
            out = cli.main([
                "--checkpoint", curriculum["finetune"], "--full-sequence",
                "--aggregation", aggregation, "--compute-dtype", "bfloat16",
                "--batch-size", str(B), "--device", "cuda", "--seed", "1",
                "--graph-dir-clinical", graph_dir,
                "--seq-path-clinical", seq_path,
                "--clinical-table-path", clin_path,
                "--figure-save-dir", os.path.join(tmp, "figures")])
            torch.cuda.synchronize()
            runs[label] = dict(out=out, wall_s=time.perf_counter() - t0,
                               scoring_s=scoring[-1], counts=read_counts())
    finally:
        cli.inference_clinical_only = real_score

    mega_run, again, plain = (runs[k] for k in ("mega", "mega again",
                                                "scatter"))
    probs = mega_run["out"]["predicted_probs"]
    valid = ~np.isnan(plain["out"]["predicted_probs"])
    batches = -(-CLINICAL_ROWS // B)
    assert len(probs) == CLINICAL_ROWS and 0 < valid.sum() < CLINICAL_ROWS
    for run in (mega_run, again):
        assert run["counts"] == (6 * batches,) + (0,) * 10, run["counts"]
    assert plain["counts"] == (0,) * 11, plain["counts"]
    assert np.array_equal(np.isnan(probs), ~valid)
    assert np.array_equal(probs, again["out"]["predicted_probs"],
                          equal_nan=True)
    err = float(np.abs(probs[valid]
                       - plain["out"]["predicted_probs"][valid]).max())
    assert err <= PROB_ATOL, err
    seq_rows, clin_rows = read_rows(seq_path), read_rows(clin_path)
    loads = survival.patient_loads(probs, seq_rows)
    assert len(loads) == CLINICAL_PATIENTS and all(
        np.isfinite(v) for v in loads.values())
    os_p, pfs_p = (mega_run["out"]["os_p_value"],
                   mega_run["out"]["pfs_p_value"])
    assert 0.0 <= os_p <= 1.0 and 0.0 <= pfs_p <= 1.0
    assert survival.clinical_pvalues(probs, seq_rows, clin_rows) == \
        (os_p, pfs_p)
    assert (again["out"]["os_p_value"], again["out"]["pfs_p_value"]) == \
        (os_p, pfs_p)
    row = dict(rows=CLINICAL_ROWS, valid_rows=int(valid.sum()),
               patients=CLINICAL_PATIENTS, batches=batches,
               launches_mega=mega_run["counts"],
               max_abs_prob_diff_vs_scatter=err, os_p_value=os_p,
               pfs_p_value=pfs_p,
               os_p_value_scatter=plain["out"]["os_p_value"],
               pfs_p_value_scatter=plain["out"]["pfs_p_value"],
               wall_s={k: r["wall_s"] for k, r in runs.items()},
               scoring_s={k: r["scoring_s"] for k, r in runs.items()},
               rows_per_s={k: CLINICAL_ROWS / r["scoring_s"]
                           for k, r in runs.items()})
    print("clinical:", json.dumps(row), flush=True)
    return row


def check_paired_no_sync(scorer) -> dict:
    """Phase 27's 'paired' forward and one 'paired' train step under
    torch.cuda.set_sync_debug_mode('error'): neither waits for the
    device."""
    from immunostruct_tpu_torch.data.synthetic import build_batch
    from immunostruct_tpu_torch.models.trunk import model_apply

    batch = build_batch(B, N, EDGE_COUNTS[0], L, paired=True, device="cuda")
    trainer, state = make_trainer("HybridModelv2", "mega",
                                  mega_variant="paired")
    trainer.train_step(state, batch, seed=0)
    gen = scorer.generator()
    torch.cuda.synchronize()
    before = read_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            out = model_apply(scorer.model, batch.graph, batch.seq_onehot,
                              batch.props, generator=gen, deterministic=True,
                              aggregation="mega",
                              compute_dtype=scorer.compute_dtype,
                              mega_variant="paired")
        state, loss = trainer.train_step(state, batch, seed=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = tuple(a - z for a, z in zip(read_counts(), before))
    assert launched[6] == 12 and launched[1] == 6, launched   # B4, B2
    assert torch.isfinite(out.logits).all() and torch.isfinite(loss)
    row = dict(launches=launched, loss=float(loss))
    print("paired without a host sync:", json.dumps(row), flush=True)
    return row


# --------------------------------------------------------------------------
# phase 27b: export and serve an artifact
# --------------------------------------------------------------------------

# the artifacts of phase 27b: (label, --aggregation, request index in
# REQUESTS, --int8); (e) is held to (a), the others to the eager server
ARTIFACTS = (("a", "auto", 0, False), ("b", "auto", 2, False),
             ("c", "fused", 0, False), ("d", "pallas", 0, False),
             ("e", "auto", 0, True))
INT8_PROB_ATOL = 0.05           # JAX's bound, tests/test_export.py
ARTIFACT_TIMED = 10             # timed requests a server


def http_timings(base: str, body: bytes, timed: int) -> tuple:
    """``timed`` posts of ``body`` to ``base``/score: (the first reply's
    probabilities, median server-side forward ms, median HTTP round trip
    ms); every reply has the first one's bits."""
    walls, forward, first = [], [], None
    for _ in range(timed + 1):
        t0 = time.perf_counter()
        status, reply = post(base + "/score", body)
        wall = (time.perf_counter() - t0) * 1e3
        assert status == 200, reply
        if first is None:
            first = reply["probs"]
            continue                    # the first call is not timed
        assert reply["probs"] == first
        walls.append(wall)
        forward.append(reply["ms"])
    return first, statistics.median(forward), statistics.median(walls)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_artifacts(plan_path: str) -> None:
    """Phase 27b's fresh process (``python -c`` from the repo root): load
    every artifact with load_exported, call each on its request twice with
    every count set to 0 before and read after, then serve each of (a)-(d)
    over HTTP through ``serve --artifact`` (the CLI's main, in a thread) and
    time it; a request of another shape is a 400 and the server lives on.
    Asserts that no model module was imported and writes what it read to
    the plan's ``out``."""
    from immunostruct_tpu_torch import serving
    from immunostruct_tpu_torch.utils.export import REQUEST_KEYS, load_exported

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(plan_path) as fh:
        plan = json.load(fh)
    t0 = time.perf_counter()
    arts = {k: load_exported(a["path"], "cuda")
            for k, a in plan["artifacts"].items()}
    load_s = time.perf_counter() - t0
    result = dict(load_s=load_s, artifacts={})
    for k, a in plan["artifacts"].items():
        with np.load(a["request"]) as z:
            tensors = [torch.from_numpy(z[key]).cuda() for key in REQUEST_KEYS]
        arts[k](*tensors)               # warm
        torch.cuda.synchronize()
        reset_counts()                  # every count to 0: the artifact
        probs = [arts[k](*tensors).cpu() for _ in range(2)]
        counts = read_counts()          # read just after it
        assert torch.equal(probs[0], probs[1]), k
        np.save(a["probs"], probs[0].numpy())
        result["artifacts"][k] = dict(launches_per_call=[c // 2
                                                         for c in counts])
        assert all(c % 2 == 0 for c in counts), (k, counts)
    for k, a in plan["artifacts"].items():
        if not a["http"]:
            continue
        port = free_port()
        threading.Thread(target=serving.main, daemon=True, args=([
            "--artifact", a["path"], "--http", str(port), "--device",
            "cuda"],)).start()
        base = f"http://127.0.0.1:{port}"
        for _ in range(600):            # until the server answers
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=30) as resp:
                    assert json.loads(resp.read()) == {"status": "ok"}
                break
            except urllib.error.URLError:
                time.sleep(0.1)
        with open(a["request"], "rb") as fh:
            body = fh.read()
        reset_counts()
        first, fwd_ms, http_ms = http_timings(base, body, ARTIFACT_TIMED)
        counts = read_counts()
        assert np.array_equal(np.asarray(first, np.float32),
                              np.load(a["probs"])), k
        with open(a["wrong"], "rb") as fh:
            try:
                post(base + "/score", fh.read())
                raise AssertionError("a request of another shape was "
                                     "answered")
            except urllib.error.HTTPError as err:
                assert err.code == 400, err
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            assert resp.status == 200
        result["artifacts"][k].update(
            median_forward_ms=fwd_ms, median_http_ms=http_ms,
            http_launches=counts, http_calls=ARTIFACT_TIMED + 1)
    loaded = sorted(m for m in sys.modules
                    if m.startswith("immunostruct_tpu_torch.models"))
    assert not loaded, loaded
    result["models_imported"] = loaded
    with open(plan["out"], "w") as fh:
        json.dump(result, fh)


def check_ops_on_card() -> list:
    """torch.library.opcheck on the four kernel ops with CUDA tensors at a
    small size (B=2, E=256, N=288, F=20, H=64), f32 and bf16; and, in bf16,
    the host time a call through the op beside the direct launch that the
    op wraps (what registering a kernel as an op costs a call)."""
    from immunostruct_tpu_torch.ops import edge, mega, segment

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        args = kernel_inputs(2, 256, 20, dtype, seed=71)
        src, dst, mask, ef, h, x, *weights = args[:10]
        rows_hx = torch.cat([h, x], dim=-1)

        def bundle(idx):
            return torch.gather(rows_hx, 1, idx.long()[..., None].expand(
                -1, -1, rows_hx.shape[-1])).transpose(1, 2).contiguous()

        m = torch.randn(2, 256, H + 3, device="cuda").to(dtype)
        hc = h.contiguous()
        mega_args = (src, dst, mask, ef, h, x, *weights)
        edge_args = (bundle(src), bundle(dst),
                     ef.transpose(1, 2).contiguous(), *weights)
        ops = torch.ops.immunostruct
        cases = (
            ("edge_mega_fwd", ops.edge_mega_fwd.default, (*mega_args, False),
             lambda: mega.edge_mega_fwd(*mega_args, residuals=False),
             lambda: mega._mega_fwd_launch(mega_args, False)),
            ("edge_mega_fwd residuals", ops.edge_mega_fwd.default,
             (*mega_args, True), None, None),
            ("edge_program_fwd", ops.edge_program_fwd.default, edge_args,
             lambda: edge.edge_program_fwd(*edge_args),
             lambda: edge._edge_fwd_launch(*edge_args)),
            ("segment_scatter", ops.segment_scatter.default,
             (dst, mask, m, N),
             lambda: segment.segment_scatter(dst, mask, m, N),
             lambda: segment._scatter_launch(dst, mask, m, N)),
            ("segment_gather", ops.segment_gather.default, (src, mask, hc),
             lambda: segment.segment_gather(src, mask, hc),
             lambda: segment._gather_launch(src, mask, hc)))
        for name, op, opargs, through_op, direct in cases:
            t0 = time.perf_counter()
            torch.library.opcheck(op, opargs)
            row = dict(op=name, dtype=str(dtype).split(".")[1],
                       opcheck_s=time.perf_counter() - t0)
            if dtype == torch.bfloat16 and through_op is not None:
                row.update(host_us_op=host_us(through_op),
                           host_us_direct=host_us(direct))
            rows.append(row)
    print("ops on the card:", json.dumps(rows), flush=True)
    return rows


def check_artifacts(scorer, requests, tmp: str) -> tuple:
    """Phase 27b: export the five artifacts through cli.export_model from a
    JAX-format checkpoint of the served model, serve them from a fresh
    process (``serve_artifacts``) and hold each to the eager server: the
    same bits and the same launches per call as the eager forward with the
    same aggregation, seed and weights ((e), int8 weights, within
    INT8_PROB_ATOL of (a)); opcheck the four ops. Returns (rows, the
    artifact (a) server's launch counts, the paths)."""
    from immunostruct_tpu_torch.cli import export_model
    from immunostruct_tpu_torch.serving import make_http_server
    from immunostruct_tpu_torch.utils.checkpoint import save_checkpoint
    from immunostruct_tpu_torch.utils.export import read_meta
    from immunostruct_tpu_torch.utils.quantize import quantized_size_bytes

    layers = len(scorer.model.gcn)
    ckpt = os.path.join(tmp, "served.ckpt")
    save_checkpoint(ckpt, scorer.model)
    rows, plan = {}, dict(artifacts={}, out=os.path.join(tmp, "served.json"))
    for label, agg, req, int8 in ARTIFACTS:
        path = os.path.join(tmp, f"artifact_{label}.pt2")
        b = REQUESTS[req][1]
        t0 = time.perf_counter()
        export_model.main([
            "--model", "HybridModelv2", "--checkpoint", ckpt, "--output",
            path, "--batch-size", str(b), "--max-nodes", str(N),
            "--max-edges", str(REQUESTS[req][2]), "--seq-len", str(L),
            "--compute-dtype", "bfloat16", "--aggregation", agg,
            "--device", "cuda", "--seed", str(scorer.seed)]
            + (["--int8"] if int8 else []))
        export_s = time.perf_counter() - t0
        meta = read_meta(path)
        assert meta["aggregation"] == ("mega" if agg == "auto" else agg), meta
        rows[label] = dict(artifact=label, aggregation=meta["aggregation"],
                           B=b, E=REQUESTS[req][2], int8=int8,
                           export_s=export_s, bytes=os.path.getsize(path))
        plan["artifacts"][label] = dict(
            path=path, request=requests[req][2], http=not int8,
            wrong=requests[2 if req == 0 else 0][2],
            probs=os.path.join(tmp, f"artifact_{label}.npy"))

    # the eager server on the same requests, same weights and seed
    eager = {}
    try:
        for label, agg, req, int8 in ARTIFACTS[:4]:
            scorer.aggregation = agg
            with open(requests[req][2], "rb") as fh:
                body = fh.read()
            reset_counts()
            probs, _ = scorer.score_request(requests[req][2])
            counts = read_counts()
            server = make_http_server(scorer, "127.0.0.1", 0)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            host, port = server.server_address[:2]
            try:
                first, fwd_ms, http_ms = http_timings(
                    f"http://{host}:{port}", body, ARTIFACT_TIMED)
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
            assert np.array_equal(np.asarray(first, np.float32), probs)
            eager[label] = dict(probs=probs, launches=counts,
                                median_forward_ms=fwd_ms,
                                median_http_ms=http_ms)
    finally:
        scorer.aggregation = "mega"

    plan_path = os.path.join(tmp, "plan.json")
    with open(plan_path, "w") as fh:
        json.dump(plan, fh)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke.serve_artifacts(sys.argv[1])",
         plan_path], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=900)
    served_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    with open(plan["out"]) as fh:
        served = json.load(fh)
    assert served["models_imported"] == []

    for label, agg, req, int8 in ARTIFACTS:
        got = np.load(plan["artifacts"][label]["probs"])
        a = served["artifacts"][label]
        row = rows[label]
        row.update(launches_per_call=a["launches_per_call"],
                   load_s_all=served["load_s"], process_s=served_s)
        assert np.isfinite(got).all() and got.shape == (row["B"],)
        if int8:
            err = float(np.abs(got - np.load(
                plan["artifacts"]["a"]["probs"])).max())
            assert err <= INT8_PROB_ATOL, err
            f32, q8 = quantized_size_bytes(scorer.model)
            row.update(max_abs_prob_diff_vs_a=err,
                       quantized_size_bytes=[f32, q8])
            assert row["launches_per_call"] == served["artifacts"]["a"][
                "launches_per_call"]
        else:
            e = eager[label]
            assert np.array_equal(got, e["probs"]), label
            assert tuple(a["launches_per_call"]) == tuple(e["launches"]), (
                label, a["launches_per_call"], e["launches"])
            if agg == "auto":           # 'mega': B1 alone, once a layer
                assert tuple(e["launches"]) == tuple(
                    layers if i == 0 else 0 for i in range(11)), e
            calls = a["http_calls"]
            assert tuple(a["http_launches"]) == tuple(
                calls * c for c in e["launches"]), (label, a)
            row.update(same_bits_as_eager=True,
                       median_forward_ms=a["median_forward_ms"],
                       median_http_ms=a["median_http_ms"],
                       eager_median_forward_ms=e["median_forward_ms"],
                       eager_median_http_ms=e["median_http_ms"])
        print("artifact:", json.dumps(row), flush=True)
    rows = list(rows.values())
    opcheck_rows = check_ops_on_card()
    paths = {label: plan["artifacts"][label] for label in ("a", "b")}
    return rows, tuple(served["artifacts"]["a"]["http_launches"]), paths, \
        opcheck_rows


def profile_artifacts(scorer, paths: dict, traced: int = 3) -> list:
    """Phase 28's rows for artifacts (a) and (b): 20 calls each of the
    artifact (called directly: eager) and of the 'mega' Scorer (captured)
    on the same request, in turn
    (each ending in a copy to the host, as a served forward does; the
    medians printed side by side), then ``traced`` artifact calls under
    torch.profiler."""
    from immunostruct_tpu_torch.serving import request_to_args
    from immunostruct_tpu_torch.utils.export import REQUEST_KEYS, load_exported

    rows = []
    scorer.aggregation = "mega"
    for label, a in paths.items():
        art = load_exported(a["path"], "cuda")
        with np.load(a["request"]) as z:
            tensors = [torch.from_numpy(z[k]).cuda() for k in REQUEST_KEYS]
        args = request_to_args(a["request"], scorer.device, scorer.model)
        calls = (("artifact", lambda: art(*tensors).cpu()),
                 ("scorer", lambda: scorer(*args)))
        walls = {kind: [] for kind, _ in calls}
        for i in range(23):
            for kind, fn in calls:
                t0 = time.perf_counter()
                fn()
                if i >= 3:              # three calls each to warm
                    walls[kind].append((time.perf_counter() - t0) * 1e3)
        profiled = device_profile(calls[0][1], traced)
        b = art.inputs[0][1][0]
        rows.append(profile_row(f"artifact ({label}) B={b} E=2560",
                                art.meta["aggregation"], profiled, traced,
                                statistics.median(walls["artifact"])))
        turn = dict(artifact=label, B=b,
                    artifact_wall_ms_median=statistics.median(
                        walls["artifact"]),
                    scorer_wall_ms_median=statistics.median(walls["scorer"]))
        print("artifact and eager in turn:", json.dumps(turn), flush=True)
        rows[-1]["in_turn"] = turn
    return rows


def device_profile(fn, traced: int, warmup: int = 0,
                   at_record=None) -> tuple:
    """``traced`` calls of ``fn`` under torch.profiler: (device time and
    launches by kernel name over the ``traced`` calls, the host's ATen
    calls per call: every ``aten::`` event, nested ones too, and those of
    them that are ``aten::_assert_tensor_metadata``, the device events
    [(start_us, end_us, name)] in time order). ``warmup`` calls run first
    with the tracer prepared but not recording (torch.profiler's schedule),
    then a sync, so that the recording starts on a tracer already up;
    ``at_record()`` is called as it starts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    plan = (schedule(wait=0, warmup=warmup, active=traced, repeat=1)
            if warmup else None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=plan) as prof:
        for _ in range(warmup):
            fn()
        if warmup:
            torch.cuda.synchronize()
            prof.step()
        if at_record is not None:
            at_record()
        for _ in range(traced):
            fn()
        torch.cuda.synchronize()
    per_name, host = {}, {"aten": 0, "_assert_tensor_metadata": 0}
    timeline = []
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith("aten::")):
            host["aten"] += 1
            if ev.name == "aten::_assert_tensor_metadata":
                host["_assert_tensor_metadata"] += 1
        # user annotations (e.g. Optimizer.step) span device work that the
        # kernels' own events already count
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = ev.time_range.end - ev.time_range.start
        tot, cnt = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (tot + us, cnt + 1)
        timeline.append((ev.time_range.start, ev.time_range.end, ev.name))
    assert per_name, "torch.profiler recorded no device activity"
    return per_name, {k: v / traced for k, v in host.items()}, \
        sorted(timeline)


def profile_row(label, agg, profiled, traced, wall) -> dict:
    """One row of phase 28: the device's busy time and idle share, and the
    time of each csrc kernel by its label in utils/attribution.py (its
    helper kernels, the bf16 projection and the chunk and block sums,
    counted with the kernel they serve)."""
    from immunostruct_tpu_torch.utils.attribution import label_events

    per_name, host, timeline = profiled
    busy_ms = sum(t for t, _ in per_name.values()) / 1e3 / traced
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:5]
    by_label = {}
    events = [(s, e, name, "") for s, e, name in timeline]
    for (s, e, _, _), lab in zip(events, label_events(events)):
        by_label[lab] = by_label.get(lab, 0.0) + (e - s) / 1e3 / traced

    def kernel_ms(b):
        return by_label.get(f"[kernel:{b}]", 0.0)

    row = dict(
        work=label, aggregation=agg, wall_ms_median=wall,
        device_busy_ms=busy_ms,
        device_ops_per_call=sum(c for _, c in per_name.values()) / traced,
        idle_share=max(0.0, 1.0 - busy_ms / wall),
        host_aten_calls=host["aten"],
        host_assert_metadata_calls=host["_assert_tensor_metadata"],
        b1_ms=kernel_ms("B1"), b2_ms=kernel_ms("B2"),
        b3_fwd_ms=kernel_ms("B3 fwd"), b3_bwd_ms=kernel_ms("B3 bwd"),
        b8_scatter_ms=kernel_ms("B8 scatter"),
        b8_gather_ms=kernel_ms("B8 gather"), b4_ms=kernel_ms("B4"),
        b5a_ms=kernel_ms("B5a"), b5b_ms=kernel_ms("B5b"),
        chunk_sum_ms=sum(t for name, (t, _) in per_name.items()
                         if "reduce_node_chunks" in name) / 1e3 / traced,
        b6_ms=kernel_ms("B6"), b7_ms=kernel_ms("B7"),
        top=[[name[:90], t / 1e3 / traced, c // traced]
             for name, (t, c) in top])
    print("profile:", json.dumps(row), flush=True)
    return row


def profile_forwards(scorer, requests, traced: int = 3) -> list:
    """Per request shape and forward ('mega', 'scatter', and 'auto' with
    fused_stack, B7): median wall time of 10 untraced forwards, then
    ``traced`` forwards under torch.profiler."""
    from immunostruct_tpu_torch.serving import request_to_args

    rows = []
    for label, _, path in requests:
        args = request_to_args(path, scorer.device, scorer.model)
        for agg in ("mega", "scatter", "fused_stack"):
            scorer.fused_stack = agg == "fused_stack"
            scorer.aggregation = "auto" if scorer.fused_stack else agg
            for _ in range(3):
                scorer(*args)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                scorer(*args)           # ends in a copy to the host
                walls.append((time.perf_counter() - t0) * 1e3)
            profiled = device_profile(lambda: scorer(*args), traced)
            rows.append(profile_row(f"forward {label}", agg, profiled,
                                    traced, statistics.median(walls)))
    scorer.aggregation, scorer.fused_stack = "mega", False
    return rows


def profile_training(traced: int = 3) -> list:
    """Train steps at B=128, E=2560 under 'mega', 'scatter', 'fused',
    'pallas' and 'mega' with mega_variant 'stack', 'inkernel' and 'paired'
    (those three on build_batch's mirror-paired batch): median wall of 8 untraced steps
    (after 3), then ``traced`` steps traced."""
    from immunostruct_tpu_torch.data.synthetic import (
        build_batch, random_sample_batch,
    )

    batch = random_sample_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                device="cuda")
    paired = build_batch(B, N, EDGE_COUNTS[0], L, paired=True, device="cuda")
    rows = []
    for agg, variant, data in (("mega", "hybrid", batch),
                               ("scatter", "hybrid", batch),
                               ("fused", "hybrid", batch),
                               ("pallas", "hybrid", batch),
                               ("mega", "stack", paired),
                               ("mega", "inkernel", paired),
                               ("mega", "paired", paired)):
        trainer, state = make_trainer("HybridModelv2", agg,
                                      mega_variant=variant)
        _, ms = timed_steps(trainer, state, data, 11)

        def step():
            trainer.train_step(state, data, seed=0)

        profiled = device_profile(step, traced)
        label = agg if variant == "hybrid" else f"{agg} / {variant}"
        rows.append(profile_row("train step B=128 E=2560", label, profiled,
                                traced, statistics.median(ms[3:])))
        del trainer, state
    return rows


# --------------------------------------------------------------------------
# the fourteenth slice: profile_step on the card (28a) and the
# device-resident corpus behind --device-data (28b)
# --------------------------------------------------------------------------

PROFILE_STEPS, PROFILE_WARMUP = 5, 3
# profile_step's runs: (label, flags, phase 28's row of the same work
# (work, aggregation) or None, the csrc kernels each names)
PROFILE_RUNS = (
    ("train", ["--aggregation", "mega", "--occupancy"],
     ("train step B=128 E=2560", "mega"), ("B1", "B2", "B8 scatter")),
    ("inference B=128", ["--inference", "--aggregation", "mega"],
     ("forward B=128 E=2560", "mega"), ("B1",)),
    ("inference B=1", ["--inference", "--batch", "1", "--aggregation",
                       "mega"], ("forward B=1 E=2560", "mega"), ("B1",)),
    ("comparative", ["--comparative", "--aggregation", "mega"], None,
     ("B1", "B2", "B8 scatter")),
)
# the reference corpus's scale (data/device_pipeline.py of the JAX
# package: ~27K structures)
REFERENCE_ROWS = 27000


def check_profile_step(tmp: str, phase28: list) -> dict:
    """Phase 28a: cli.profile_step in this process at full width
    (HybridModelv2, B=128, N=288, L=284, E=2560, bf16, 'mega'): the train
    step with --occupancy, --inference at B=128 and B=1, --comparative.
    Each run names the csrc kernels its path launches and no other, and
    its rows sum to within 10% of phase 28's device-busy time for the same
    work; then the MFU of the 'mega' step from utils/flops.py."""
    from immunostruct_tpu_torch.cli import profile_step
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch
    from immunostruct_tpu_torch.models import model_map
    from immunostruct_tpu_torch.utils import flops

    rows, launches = {}, {}
    for label, flags, same, kernels in PROFILE_RUNS:
        reset_counts()
        t0 = time.perf_counter()
        out = profile_step.main(flags + [
            "--steps", str(PROFILE_STEPS), "--warmup", str(PROFILE_WARMUP),
            "--logdir", os.path.join(tmp, "profile_step"), "--top", "12"])
        torch.cuda.synchronize()
        launches[label] = read_counts()
        named = sorted(lab[len("[kernel:"):-1] for _, lab in out["rows"]
                       if lab.startswith("[kernel:"))
        assert named == sorted(kernels), (label, out["rows"])
        row = dict(run=label, wall_s=time.perf_counter() - t0,
                   device_total_ms=out["device_total_ms"],
                   rows=out["rows"][:15], launches=launches[label],
                   labels_by_kind={
                       kind: sum(1 for _, lab in out["rows"]
                                 if lab.startswith(prefix))
                       for kind, prefix in (("kernel", "[kernel:"),
                                            ("file_line",
                                             "immunostruct_tpu_torch/"),
                                            ("aten", "[aten::"))})
        if same is not None:
            ref = next(r for r in phase28 if (r["work"], r["aggregation"])
                       == same)
            row["phase28_device_busy_ms"] = ref["device_busy_ms"]
            row["ratio_to_phase28"] = (out["device_total_ms"]
                                       / ref["device_busy_ms"])
            assert abs(row["ratio_to_phase28"] - 1.0) <= 0.10, row
        if "occupancy" in out:
            occ = out["occupancy"]
            row["occupancy"] = dict(occ, gaps=occ["gaps"][:3])
        print("profile_step:", json.dumps(row), flush=True)
        rows[label] = row
    steps = PROFILE_STEPS + PROFILE_WARMUP
    # per step: 6 B1, 6 B2 and 12 B8 scatters under 'mega'; 6 B1 a forward
    assert launches["train"] == (6 * steps, 6 * steps, 0, 0, 12 * steps,
                                 0, 0, 0, 0, 0, 0), launches
    for label in ("inference B=128", "inference B=1"):
        assert launches[label] == (6 * steps,) + (0,) * 10, launches
    twin = launches["comparative"]
    assert twin[0] == twin[1] > 0 and twin[4] == 2 * twin[0] and \
        sum(twin) == 4 * twin[0], launches

    # MFU of the 'mega' step: the analytic model FLOPs over phase 28's
    # median wall and its device-busy time, against the card's peak
    mega_row = next(r for r in phase28 if (r["work"], r["aggregation"])
                    == ("train step B=128 E=2560", "mega"))
    trainer, state = make_trainer("HybridModelv2", "mega")
    n_params = flops.param_count(state.model)
    analytic = flops.train_step_flops(model_map["HybridModelv2"], B, N,
                                      EDGE_COUNTS[0], L * 21, n_params)
    batch = random_sample_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                device="cuda")
    executed = flops.executed_flops(trainer.train_step, state, batch, 0)
    peak = flops.peak_flops("cuda", "bfloat16")
    mfu = dict(params=n_params, analytic_tflop_per_step=analytic / 1e12,
               executed_aten_tflop_per_step=executed / 1e12,
               peak_tflops_bf16=None if peak is None else peak / 1e12,
               wall_ms=mega_row["wall_ms_median"],
               device_busy_ms=mega_row["device_busy_ms"],
               mfu_of_wall=(None if peak is None else analytic
                            / (mega_row["wall_ms_median"] / 1e3) / peak),
               mfu_of_device_time=(None if peak is None else analytic
                                   / (mega_row["device_busy_ms"] / 1e3)
                                   / peak),
               idle_share_occupancy=rows["train"]["occupancy"]["idle_frac"],
               idle_share_phase28=mega_row["idle_share"],
               launches=launches)
    del trainer, state
    print("mfu:", json.dumps(mfu), flush=True)
    return dict(runs=rows, mfu=mfu)


def _tensors(batch) -> list:
    from immunostruct_tpu_torch.structs import map_tensors

    out = []
    map_tensors(out.append, batch)
    return out


def _same_batches(a, b) -> bool:
    """Every tensor of two batches equal, dtype and device included."""
    return all(x.dtype == y.dtype and x.device == y.device
               and torch.equal(x, y)
               for x, y in zip(_tensors(a), _tensors(b)))


def _checkpoints(save_dir: str) -> dict:
    out = {}
    for f in sorted(os.listdir(save_dir)):
        if f.endswith(".ckpt"):
            with np.load(os.path.join(save_dir, f)) as z:
                out[f] = {k: z[k] for k in z.files}
    return out


def _same_checkpoints(a: str, b: str) -> bool:
    ca, cb = _checkpoints(a), _checkpoints(b)
    return ca.keys() == cb.keys() and len(ca) == 2 and all(
        ca[f].keys() == cb[f].keys() and all(
            ca[f][k].dtype == cb[f][k].dtype
            and np.array_equal(ca[f][k], cb[f][k]) for k in ca[f])
        for f in ca)


def _with_flags(argv: list, save_dir: str, *flags) -> list:
    out = list(argv)
    out[out.index("--model-save-dir") + 1] = save_dir
    return out + list(flags)


def run_entry(cli, argv: list) -> dict:
    """``cli.main(argv)`` with each stage's pipeline kind, history and
    launches recorded (every count set to 0 before the entry point)."""
    stages, real = [], cli.train_model

    def train_model(config, model, train_pipe, *args, **kw):
        before = read_counts()
        model, history = real(config, model, train_pipe, *args, **kw)
        stages.append(dict(stage=kw["stage"],
                           pipeline=type(train_pipe).__name__,
                           steps=len(train_pipe), history=history,
                           launches=[a - z for a, z in zip(read_counts(),
                                                           before)]))
        return model, history

    cli.train_model = train_model
    try:
        reset_counts()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        cli.train_model = real
    return dict(stages=stages, wall_s=wall_s, launches=read_counts())


def _losses(stages) -> list:
    return [(h["train_loss"], h["val_loss"])
            for h in (s["history"] for s in stages)]


def _epoch_occupancy(trainer, state, pipe) -> dict:
    """Two steps to warm, then one epoch traced (the device's kernels,
    copies and fills only): the device's busy time and idle share over
    the epoch from utils/attribution.py::occupancy."""
    from torch.profiler import ProfilerActivity, profile

    from immunostruct_tpu_torch.data.pipeline import prefetch
    from immunostruct_tpu_torch.utils.attribution import occupancy

    for _, batch in zip(range(2), pipe.epoch(0)):
        trainer.train_step(state, batch, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in prefetch(pipe.epoch(1)):
            trainer.train_step(state, batch, seed=0)
        torch.cuda.synchronize()
    timeline = sorted(
        (ev.time_range.start, ev.time_range.end, ev.name)
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(ev, "is_user_annotation", False))
    occ = occupancy(timeline, 1)
    return dict(pipeline=type(pipe).__name__, steps=len(pipe),
                idle_share=occ["idle_frac"], busy_ms=occ["busy_ms"],
                span_ms=occ["span_ms"])


def check_device_data(tmp: str, entry: dict, cancer: dict) -> dict:
    """Phase 28b: the device-resident corpus on the card, (a)-(e) of the
    module docstring."""
    import copy

    from immunostruct_tpu_torch.cli import train_Cancer_wFT, train_IEDB_wFT
    from immunostruct_tpu_torch.cli.common import device_data_budget
    from immunostruct_tpu_torch.config import Config
    from immunostruct_tpu_torch.data.dataset import (
        ComparativeDataset, GraphArrays, ImmunoDataset, seeded_split,
    )
    from immunostruct_tpu_torch.data.device_pipeline import (
        ComparativeDevicePipeline, DevicePipeline, build_device_corpus,
        estimate_device_bytes, gather_batch,
    )
    from immunostruct_tpu_torch.data.pipeline import (
        BatchPipeline, ComparativePipeline,
    )

    out = {}
    # (a) the corpus of phase 19: the estimate is the uploaded bytes
    cfg = Config(device="cuda", batch_size=B, seed=1, full_sequence=True)
    ds = ImmunoDataset.load(cfg, *entry["corpus"])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    corpus = build_device_corpus(ds, binary=True, full=True, device="cuda")
    torch.cuda.synchronize()
    need = estimate_device_bytes(ds, full=True)
    assert need == corpus.nbytes(), (need, corpus.nbytes())
    out["corpus"] = dict(rows=len(ds), graphs=int(ds.graphs.num_nodes.size),
                         estimate_bytes=need, nbytes=corpus.nbytes(),
                         memory_allocated_growth=(
                             torch.cuda.memory_allocated() - before),
                         budget_bytes=device_data_budget("cuda"))
    del corpus

    # (b) one epoch of the device pipeline is the host pipeline's
    tr, va, _ = seeded_split(len(ds), (0.8, 0.1, 0.1), cfg.seed)
    for split, idx in (("val", va), ("train", tr)):
        host = BatchPipeline(ds, idx, split=split, binary=True, full=True,
                             config=cfg)
        dev = DevicePipeline(ds, idx, split=split, binary=True, full=True,
                             config=cfg, pad_final_batch=False)
        pairs = list(zip(host.epoch(0), dev.epoch(0)))
        assert len(pairs) == len(dev) and all(_same_batches(h, d)
                                              for h, d in pairs), split
        out[f"equal_batches_{split}"] = len(pairs)

    # (c) the entry points by default (auto: the device pipeline; phases 19
    # and 21) and with --no-device-data, in turn
    assert entry["pipelines"] == ["DevicePipeline"] * 2, entry["pipelines"]
    assert cancer["pipelines"] == ["DevicePipeline",
                                   "ComparativeDevicePipeline",
                                   "ComparativeDevicePipeline"], cancer
    turns = {}
    for name, cli, row in (("IEDB", train_IEDB_wFT, entry),
                           ("Cancer", train_Cancer_wFT, cancer)):
        runs = [("auto", dict(
            wall_s=row["wall_s"], epochs=[e["epoch_s"] for e in row["epochs"]]))]
        # host, auto, host: with phase 19/21 (auto) two alternations; the
        # second at one epoch a stage and without the clinical pass (time)
        for i, host in enumerate((True, False, True)):
            save = os.path.join(tmp, f"{name}_turn{i}")
            flags = ["--no-device-data"] if host else []
            if i:
                flags += ["--num-epochs", "1"] + (
                    ["--skip-clinical"] if name == "Cancer" else [])
            r = run_entry(cli, _with_flags(row["argv"], save, *flags))
            kinds = {s["pipeline"] for s in r["stages"]}
            assert (kinds <= {"BatchPipeline", "ComparativePipeline"}) == \
                host, kinds
            if i == 0:
                # the same losses, checkpoints and launches as phase 19/21
                assert _losses(r["stages"]) == [
                    ([e["train_loss"] for e in row["epochs"]
                      if e["stage"] == st][:CLI_EPOCHS],
                     [e["val_loss"] for e in row["epochs"]
                      if e["stage"] == st][:CLI_EPOCHS])
                    for st in dict.fromkeys(e["stage"] for e in row["epochs"])
                ], (name, _losses(r["stages"]))
                assert _same_checkpoints(save, row["save_dir"]), name
                want = (list(row["launches_by_stage"].values())
                        if isinstance(row["launches_by_stage"], dict)
                        else row["launches_by_stage"])
                assert [s["launches"] for s in r["stages"]] == want, name
            runs.append(("host" if host else "auto",
                         dict(wall_s=r["wall_s"], epochs=[
                             t for s in r["stages"]
                             for t in s["history"]["epoch_time"]])))
        turns[name] = runs
        print(f"device data turns ({name}):", json.dumps(runs), flush=True)
    out["turns"] = turns

    # the device's idle share over one epoch, device and host pipelines:
    # the IEDB finetune ('fused') and the Cancer stage 3 ('pallas')
    cds = ComparativeDataset.load(
        cfg, *[cancer["argv"][cancer["argv"].index(f) + 1] for f in (
            "--graph-dir-cancer", "--graph-dir-wildtype",
            "--property-path-cancer", "--property-path-wildtype",
            "--hla-path")])
    tr2, _, _ = seeded_split(len(cds), (0.8, 0.1, 0.1), cfg.seed)
    occupancy_rows = []
    vae_dim = ds.seq_full.shape[1] * 21
    for label, model, agg, coeff, pipes in (
            ("IEDB finetune 'fused'", "HybridModelv2", "fused", 0.0, [
                cls(ds, tr, split="train", binary=True, full=True,
                    config=cfg, **kw)
                for cls, kw in ((DevicePipeline, {"pad_final_batch": False}),
                                (BatchPipeline, {}))]),
            ("Cancer stage 3 'pallas'", "HybridModelv2_Comparative",
             "pallas", 0.1, [
                 cls(cds, tr2, split="train", binary=True, full=True,
                     config=cfg, extend_to=MIN_FINETUNING_BATCHES * B, **kw)
                 for cls, kw in ((ComparativeDevicePipeline,
                                  {"pad_final_batch": False}),
                                 (ComparativePipeline, {}))])):
        trainer, state = make_trainer(model, agg, coeff=coeff,
                                      vae_dim=vae_dim)
        for pipe in pipes:
            r = dict(work=label, **_epoch_occupancy(trainer, state, pipe))
            occupancy_rows.append(r)
            print("epoch occupancy:", json.dumps(r), flush=True)
        del trainer, state
    out["epoch_occupancy"] = occupancy_rows

    # (d) the augmented device pipeline: SSL, 5 sequence and 5 structure
    # masks, under 'mega'
    out["augmented"] = check_augmented(tmp, entry, ds)

    # (e) the reference scale: 27,000 rows, one graph each
    reps = -(-REFERENCE_ROWS // len(ds))

    def tile(a):
        return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:REFERENCE_ROWS]

    big = copy.copy(ds)
    for k in ("seq_full", "seq_pep", "props", "immuno", "foreign_norm"):
        setattr(big, k, tile(getattr(ds, k)))
    gi = tile(ds.graph_idx)
    big.graphs = GraphArrays(**{
        k: getattr(ds.graphs, k)[gi] for k in (
            "node_onehot", "coords", "edge_src", "edge_dst", "edge_mask",
            "node_mask", "num_nodes")})
    big.graph_idx = np.arange(REFERENCE_ROWS, dtype=np.int32)
    need = estimate_device_bytes(big, full=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = build_device_corpus(big, binary=True, full=True, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    assert corpus.nbytes() == need
    rng = np.random.default_rng(0)
    rows = [rng.choice(REFERENCE_ROWS, B, replace=False) for _ in range(20)]
    on_card = [torch.from_numpy(r.astype(np.int32)).cuda() for r in rows]
    turn = iter(range(1 << 30))

    def gather():           # a new set of rows each call
        gather_batch(corpus, on_card[next(turn) % len(on_card)])

    device_us = device_ms(gather, calls=len(on_card)) * 1e3
    gather_host_us = host_us(gather, calls=200)
    host_pipe = BatchPipeline(big, np.arange(REFERENCE_ROWS), split="val",
                              binary=True, full=True, config=cfg)
    host_pipe._assemble(rng, rows[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in rows:
        host_pipe._assemble(rng, r)
    torch.cuda.synchronize()
    host_pipeline_us = (time.perf_counter() - t0) / len(rows) * 1e6
    out["reference_scale"] = dict(
        rows=REFERENCE_ROWS, N=int(big.graphs.node_onehot.shape[1]),
        E=int(big.graphs.edge_src.shape[1]), L=int(big.seq_full.shape[1]),
        bytes=need, bytes_per_row=need / REFERENCE_ROWS, upload_s=upload_s,
        gather_device_us=device_us, gather_host_us=gather_host_us,
        host_pipeline_us=host_pipeline_us, batch=B)
    del corpus, big
    print("device data:", json.dumps(out), flush=True)
    return out


# --------------------------------------------------------------------------
# phase 29: parallelism (parallel/*)
# --------------------------------------------------------------------------

# 29b: the full-width 'mega' steps over two ranks sharing the card (gloo)
DP_RANKS = 2
# 29c: the full-width twin model at a global B=32, f32, VAE noise pinned
MP_BATCH = 32
# the dry run's gradient bound (``__graft_entry__.py``, JAX's): rtol 2e-4,
# atol 2e-4 * max|g| per parameter
MP_GRAD_RTOL = 2e-4
# 29b's parameters after the step against the one-process step (JAX's
# test_parallel.py): rtol 2e-5, atol 2e-6
DP_PARAM_RTOL, DP_PARAM_ATOL = 2e-5, 2e-6
# the contrastive projector's first weight, read on its own in 29b
PROJECTOR_W = "contrastive_projector.fc1.w"
# 29b's twin control (dropout 0, VAE noise pinned) is read at these seeds
# (batch and weights)
TWIN_SEEDS = (0, 1, 2)


def _grad_bound_ratio(got: dict, want: dict) -> float:
    """Phase 16's first-step bound: the largest ||got - want|| over
    STEP_GRAD_RTOL * ||want|| + STEP_GRAD_ATOL * (the largest ||want||)."""
    top = max(g.norm().item() for g in want.values())
    return max((got[k] - g).norm().item()
               / (STEP_GRAD_RTOL * g.norm().item() + STEP_GRAD_ATOL * top)
               for k, g in want.items())


def check_parallel_entry_points(tmp: str, entry: dict, cancer: dict,
                                card: str) -> dict:
    """Phase 29a: train_IEDB_wFT under 'mega' and train_Cancer_wFT under
    'pallas' on phase 19/21's corpora, one epoch a stage (the Cancer run
    without its clinical pass), with --data-parallel (a group of one over
    NCCL, joined in this process) and without: the same checkpoint bits,
    losses and launches; then the NCCL all-reduce of the flagship's flat
    f32 gradient buffer, timed."""
    import torch.distributed as dist

    from immunostruct_tpu_torch.cli import train_Cancer_wFT, train_IEDB_wFT
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.parallel.collectives import psum
    from immunostruct_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh, shutdown_distributed,
    )

    out = {}
    for name, cli, row, agg, extra in (
            ("IEDB", train_IEDB_wFT, entry, "mega", []),
            ("Cancer", train_Cancer_wFT, cancer, "pallas",
             ["--skip-clinical"])):
        runs = {}
        for tag, flags in (("plain", []), ("dp", ["--data-parallel"])):
            save = os.path.join(tmp, f"parallel_{name}_{tag}")
            r = run_entry(cli, _with_flags(
                row["argv"], save, "--aggregation", agg, "--num-epochs", "1",
                *extra, *flags))
            assert not dist.is_initialized()    # the group of one was left
            runs[tag] = dict(save=save, losses=_losses(r["stages"]),
                             launches=[s["launches"] for s in r["stages"]],
                             pipelines=[s["pipeline"] for s in r["stages"]],
                             wall_s=r["wall_s"])
        p, d = runs["plain"], runs["dp"]
        assert d["losses"] == p["losses"], (name, d["losses"], p["losses"])
        assert d["launches"] == p["launches"], (name, d["launches"])
        assert _same_checkpoints(d["save"], p["save"]), name
        assert all(k in ("BatchPipeline", "ComparativePipeline")
                   for k in d["pipelines"]), d["pipelines"]
        out[name] = dict(aggregation=agg, losses=d["losses"],
                         launches=d["launches"], wall_s_dp=d["wall_s"],
                         wall_s_plain=p["wall_s"],
                         pipelines_dp=d["pipelines"],
                         pipelines_plain=p["pipelines"])
        print(f"parallel 29a [{card}]: {name} --data-parallel (NCCL, group "
              f"of one) under '{agg}': the run's checkpoint bits, losses "
              f"{d['losses']} and launches by stage {d['launches']}; "
              f"{d['wall_s']:.1f} s (without: {p['wall_s']:.1f} s)",
              flush=True)

    # the all-reduce of one step's flat gradient buffer, NCCL, one rank
    _, model = build_model("HybridModelv2", L * 21,
                           torch.Generator().manual_seed(0))
    size = sum(t.numel() for t in model.parameters())
    initialize_distributed(device="cuda", verbose=False)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh = make_mesh("data")
        flat = torch.ones(size, device="cuda")
        ms = cuda_ms(lambda: psum(flat, "data", mesh))
    finally:
        shutdown_distributed()
    out["nccl_all_reduce"] = dict(parameters=size, bytes=4 * size, ms=ms)
    print(f"parallel 29a [{card}]: NCCL all_reduce (world 1) of the flat "
          f"gradient buffer, {size} f32 ({4 * size / 1e6:.1f} MB): "
          f"{ms:.4f} ms", flush=True)
    return out


def twin_readings(got: dict, ref: dict) -> dict:
    """One run of the twin step against the one-process step: the worst
    parameter excess over JAX's bound (rtol 2e-5, atol 2e-6) and the worst
    gradient excess over phase 29c's rule, each with its parameter, the
    projector's fc1.w gradient excess alone, and ``dryrun.twin_excess``
    (the rule 29b holds the twin to)."""
    from immunostruct_tpu_torch.parallel.dryrun import (
        excess_by_param, twin_excess, worst_grad_excess,
    )

    by_param = excess_by_param(got["params"], ref["params"], DP_PARAM_RTOL,
                               DP_PARAM_ATOL)
    by_grad = {k: worst_grad_excess({k: got["grads"][k]}, {k: g},
                                    MP_GRAD_RTOL, MP_GRAD_RTOL)
               for k, g in ref["grads"].items()}
    worst_p = max(by_param, key=by_param.get)
    worst_g = max(by_grad, key=by_grad.get)
    return dict(param_excess=by_param[worst_p], worst_param=worst_p,
                grad_excess=by_grad[worst_g], worst_grad=worst_g,
                projector_grad_excess=by_grad[PROJECTOR_W],
                rule=twin_excess(got, ref))


def check_data_parallel(card: str) -> dict:
    """Phase 29b: two ranks share the card over gloo: the full-width
    HybridModelv2 'mega' step at a global B=128 (64 a rank, E=2560) in f32
    and bf16, and the twin step (contrastive 0.1), each against the
    one-process step on the same batch; the twin's control (``twin_fixed``:
    dropout 0, the VAE noise pinned) at the seeds ``TWIN_SEEDS``, whose
    one-process step is also taken on the batch with its rows reversed;
    shard_map_train_step's ring against psum; each rank's launches, step
    time and reduction time.

    The twin step is ill-conditioned in the order of its sums: the one
    process parts from itself on its rows reversed by far more than JAX's
    bounds, at entries whose gradient is rounding noise. The twin's steps
    are held to ``dryrun.twin_excess``'s rule: gradients within phase
    29c's rule plus 1e-5 of the step's largest gradient, parameters within
    JAX's bound but at entries whose reference gradient is nonzero and
    below that term (dropped and counted). The reversed steps must meet
    the rule too: it is one the reference meets."""
    from immunostruct_tpu_torch.parallel.dryrun import (
        StepCase, dp_checks, excess_by_param, spawn, worst_excess,
    )

    full = dict(b=B, nodes=N, edges=EDGE_COUNTS[0], seq_len=L,
                aggregation="mega")
    twin = StepCase(name="HybridModelv2_Comparative", dtype="float32",
                    coeff=0.1, **full)
    fixed = {f"twin_fixed_s{seed}": dataclasses.replace(
        twin, overrides=(("dropout_rate", 0.0),), pinned=True, seed=seed)
        for seed in TWIN_SEEDS}
    cases = {"f32": StepCase(name="HybridModelv2", dtype="float32", **full),
             "twin": twin, **fixed,
             "bf16": StepCase(name="HybridModelv2", dtype="bfloat16",
                              **full)}
    t0 = time.perf_counter()
    ranks = spawn(dp_checks, DP_RANKS, cases, cases["f32"], 5, 5, 1,
                  tuple(fixed), device="cuda")
    spawn_s = time.perf_counter() - t0
    out = {"backend": ranks[0]["f32"]["backend"], "ranks": DP_RANKS,
           "wall_s": spawn_s}
    assert out["backend"] == "gloo", out["backend"]
    assert not any(r[k]["jax_loaded"] for r in ranks for k in cases)
    failures = []
    for name in fixed:
        ref = ranks[0][name + "/ref"]
        rev = ranks[0][name + "/reversed"]
        out[name + "/reversed"] = dict(loss=rev["losses"][0],
                                       **twin_readings(rev, ref))
        rule = out[name + "/reversed"]["rule"]
        if max(rule["grads"], rule["params"]) > 1.0:
            failures.append((name + "/reversed", rule))
        print(f"parallel 29b [{card}]: {name}, one process, rows reversed: "
              + json.dumps(out[name + "/reversed"]), flush=True)
    for name in cases:
        ref = ranks[0][name + "/ref"]
        for i, r in enumerate(ranks):
            got = r[name]
            assert got["rows"] == B // DP_RANKS
            assert all(np.isfinite(got["losses"]))
            rel = abs(got["losses"][0] - ref["losses"][0]) / abs(
                ref["losses"][0])
            # each rank launches the one-process step's kernels, with its
            # half of the batch: 6 B1, 6 B2 a pass
            assert got["launches"] == ref["launches"], (got["launches"],
                                                        ref["launches"])
            if name == "bf16":
                assert rel <= STEP_LOSS_RTOL, (name, rel)
                ratio = _grad_bound_ratio(got["grads"], ref["grads"])
                assert ratio <= 1.0, (name, ratio)
                reading = dict(loss_rel=rel, grad_bound_ratio=ratio)
            elif name.startswith("twin"):
                assert rel <= 2e-5, (name, rel)
                reading = dict(loss_rel=rel, **twin_readings(got, ref))
                rule = reading["rule"]
                if max(rule["grads"], rule["params"]) > 1.0:
                    failures.append((name, i, rule))
            else:
                assert rel <= 1e-5, (name, rel)
                by_param = excess_by_param(got["params"], ref["params"],
                                           DP_PARAM_RTOL, DP_PARAM_ATOL)
                worst = max(by_param, key=by_param.get)
                assert by_param[worst] <= 1.0, (name, worst, by_param)
                reading = dict(loss_rel=rel, param_excess=by_param[worst],
                               worst_param=worst)
            out.setdefault(name, []).append(dict(
                rank=i, loss=got["losses"][0], ref_loss=ref["losses"][0],
                launches={k: v for k, v in got["launches"].items() if v},
                **reading))
        print(f"parallel 29b [{card}]: {name}: " + json.dumps(out[name]),
              flush=True)
    assert not failures, failures
    assert ranks[0]["f32"]["launches"]["B1"] == 6
    assert ranks[0]["f32"]["launches"]["B2"] == 6
    for i, r in enumerate(ranks):
        ring, ps = r["ring"]["ring"], r["ring"]["psum"]
        rel = abs(ring["loss"] - ps["loss"]) / abs(ps["loss"])
        assert rel <= 1e-5, rel
        out.setdefault("ring_vs_psum", []).append(dict(
            rank=i, loss_rel=rel,
            param_excess=worst_excess(ring["params"], ps["params"], 1e-4,
                                      1e-6)))
        out.setdefault("step_ms", []).append(r["f32"]["step_ms"])
        out.setdefault("reduce_ms", []).append(r["f32"]["reduce_ms"])
    out["parameters"] = ranks[0]["f32"]["parameters"]
    print(f"parallel 29b [{card}]: ring vs psum "
          + json.dumps(out["ring_vs_psum"]), flush=True)
    for i in range(DP_RANKS):
        print(f"parallel 29b [{card}]: rank {i} of {DP_RANKS} (gloo, one "
              f"card): f32 'mega' step at {B // DP_RANKS} rows, median "
              f"{statistics.median(out['step_ms'][i]):.2f} ms "
              f"({out['step_ms'][i]}); gloo all_reduce of the "
              f"{out['parameters']}-f32 gradient buffer, median "
              f"{statistics.median(out['reduce_ms'][i]):.2f} ms "
              f"({out['reduce_ms'][i]})", flush=True)
    return out


def check_model_parallel(card: str) -> dict:
    """Phase 29c: the full-width twin model at a global B=32, E=2560, f32,
    VAE noise pinned and dropout off, against the one-process dense step:
    TP over 2 ranks, TP x DP on (2, 2), GPipe over 5 ranks (the 5 hidden
    convs, 2 microbatches); loss within rtol 2e-5, gradients within rtol
    2e-4 and atol 2e-4 * max|g| on every rank; each rank's launches."""
    from immunostruct_tpu_torch.parallel.dryrun import (
        StepCase, mp_checks, spawn, worst_grad_excess,
    )

    case = StepCase(name="HybridModelv2_Comparative", b=MP_BATCH, nodes=N,
                    edges=EDGE_COUNTS[0], seq_len=L, aggregation="mega")
    plans = (("tp", 2, [("tp", case, (2,), ("model",),
                         dict(tp_axis="model"), None)]),
             ("tp_dp", 4, [("tp_dp", case, (2, 2), ("data", "model"),
                            dict(tp_axis="model"), "data")]),
             ("pp", 5, [("pp", case, (5,), ("pipe",),
                         dict(pp_axis="pipe", pp_microbatches=2), None)]))
    out = {}
    for label, n, runs in plans:
        t0 = time.perf_counter()
        ranks = spawn(mp_checks, n, runs, 3, device="cuda")
        want = ranks[0][label + "/ref"]
        rows = []
        for i, r in enumerate(ranks):
            got = r[label]
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            excess = worst_grad_excess(got["grads"], want["grads"],
                                       MP_GRAD_RTOL, MP_GRAD_RTOL)
            assert rel <= 2e-5, (label, i, rel)
            assert excess <= 1.0, (label, i, excess)
            rows.append(dict(rank=i, coords=got["coords"], loss_rel=rel,
                             grad_excess=excess, step_ms=got["step_ms"],
                             launches={k: v for k, v in
                                       got["launches"].items() if v}))
        if label == "pp":
            # each stage: the input conv, then its hidden conv on the 2
            # microbatches, for each twin: 6 B1 and 6 B2
            for row in rows:
                assert row["launches"].get("B1") == 6, row
                assert row["launches"].get("B2") == 6, row
        out[label] = dict(ranks=n, wall_s=time.perf_counter() - t0,
                          dense_launches={k: v for k, v in
                                          want["launches"].items() if v},
                          rows=rows)
        print(f"parallel 29c [{card}]: {label} over {n} ranks: "
              + json.dumps(out[label]), flush=True)
    return out


# --------------------------------------------------------------------------
# phase 30: the contrastive term under gradient accumulation
# --------------------------------------------------------------------------

ACCUM_K = 2
ACCUM_WINDOWS = 2               # timed windows of each step, in turn
ACCUM_WINDOW_STEPS = 4
# 30b's stage 3 at 8 steps an epoch (phase 21's 64 take ~10 s a run)
ACCUM_FINETUNE_BATCHES = 8


def half_steps(trainer, state, batch, seed: int, k: int):
    """The accumulated step written out: the k slices of ``batch``, each
    the k=1 ``trainer``'s loss and backward in turn, drawing from one
    generator, the gradients and losses summed then scaled by 1/k, then
    the optimizer's step. Returns (state, loss)."""
    from immunostruct_tpu_torch.procedures.train import step_generator
    from immunostruct_tpu_torch.structs import map_tensors

    generator = step_generator(seed, state.step, "cuda")
    state.optimizer.zero_grad(set_to_none=True)
    size, total = B // k, None
    for i in range(k):
        part = map_tensors(lambda t, i=i: t[i * size:(i + 1) * size], batch)
        loss, _ = trainer._batch_loss_aux(state.model, part, generator,
                                          False)
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    with torch.no_grad():
        for p in state.model.parameters():
            if p.grad is not None:
                p.grad.mul_(1.0 / k)
    trainer.optimizer.apply_lr(state.optimizer, state.step)
    state.optimizer.step()
    state.step += 1
    return state, total * (1.0 / k)


def check_accumulated_twin(card: str) -> dict:
    """Phase 30a: the full-width twin Trainer step (B=128, E=2560, 'mega',
    contrastive 0.1) with grad_accum_steps=2 and
    allow_microbatch_contrastive, in bf16 and f32: without the opt-in the
    Trainer raises before any launch; with it one step launches twice the
    k=1 twin step's kernels (24 B1, 24 B2, 48 B8 scatters) and equals,
    bit for bit (loss, parameters), the two half-batch steps taken on one
    generator, summed then halved (``half_steps``); then the k=2 and the
    k=1 step timed in turn (bf16)."""
    from immunostruct_tpu_torch.data.synthetic import random_comparative_batch

    batch = random_comparative_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                     device="cuda")
    name, out = "HybridModelv2_Comparative", {}
    for label, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        kw = dict(coeff=0.1, compute_dtype=dtype, grad_accum_steps=ACCUM_K)
        reset_counts()
        try:
            make_trainer(name, "mega", **kw)
            raise AssertionError("the Trainer took the contrastive term "
                                 "under accumulation without the opt-in")
        except ValueError as e:
            assert "allow_microbatch_contrastive" in str(e), e
        assert read_counts() == (0,) * 11, read_counts()
        acc, acc_state = make_trainer(name, "mega",
                                      allow_microbatch_contrastive=True, **kw)
        one, one_state = make_trainer(name, "mega", coeff=0.1,
                                      compute_dtype=dtype)
        reset_counts()                  # every count to 0: the k=2 step
        acc_state, loss = acc.train_step(acc_state, batch, seed=0)
        torch.cuda.synchronize()
        counts = read_counts()          # read just after it
        one_state, want = half_steps(one, one_state, batch, 0, ACCUM_K)
        torch.cuda.synchronize()
        differ = sum(int((p != q).sum()) for p, q in zip(
            acc_state.model.parameters(), one_state.model.parameters()))
        assert counts == (24, 24, 0, 0, 48) + (0,) * 6, counts
        assert torch.equal(loss, want), (float(loss), float(want))
        assert differ == 0, differ
        assert math.isfinite(float(loss))
        row = dict(loss=float(loss), launches=counts,
                   entries_that_differ=differ)
        if dtype == torch.bfloat16:
            ms = {"k2": [], "k1": []}
            for _ in range(ACCUM_WINDOWS):
                for key, (tr, st) in (("k1", (one, one_state)),
                                      ("k2", (acc, acc_state))):
                    ms[key] += timed_steps(tr, st, batch,
                                           ACCUM_WINDOW_STEPS)[1][1:]
            row.update(step_ms_k2=statistics.median(ms["k2"]),
                       step_ms_k1=statistics.median(ms["k1"]),
                       step_ms=ms)
        out[label] = row
        print(f"accum 30a [{card}]: twin step k={ACCUM_K} {label}: "
              + json.dumps(row), flush=True)
    return out


class StandInWandb:
    """A module in wandb's place that records its calls (the run needs no
    network and the card's machine has no wandb)."""

    def __init__(self):
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, metrics):
        self.calls.append(("log", dict(metrics)))

    def finish(self):
        self.calls.append(("finish", {}))


def check_accumulated_entry_points(tmp: str, entry: dict, cancer: dict,
                                   card: str) -> dict:
    """Phase 30b: train_Cancer_wFT --grad-accum-steps 2 --coeff-contrastive
    0.1 --allow-microbatch-contrastive under 'pallas' on phase 21's
    corpora, one epoch a stage (the third of 8 steps), without its
    clinical pass, with --data-parallel (a group of one) and without: the
    same checkpoint bits, losses and launches (B8 alone); then
    train_IEDB_wFT under
    'fused' with --wandb-username and a stand-in wandb module: one init,
    every line of the run's JSONL file logged, one finish."""
    from immunostruct_tpu_torch.cli import train_Cancer_wFT, train_IEDB_wFT

    runs = {}
    for tag, flags in (("plain", []), ("dp", ["--data-parallel"])):
        save = os.path.join(tmp, f"accum_Cancer_{tag}")
        r = run_entry(train_Cancer_wFT, _with_flags(
            cancer["argv"], save, "--num-epochs", "1", "--skip-clinical",
            "--min-finetuning-batches", str(ACCUM_FINETUNE_BATCHES),
            "--grad-accum-steps", str(ACCUM_K),
            "--allow-microbatch-contrastive", *flags))
        runs[tag] = dict(save=save, losses=_losses(r["stages"]),
                         launches=[s["launches"] for s in r["stages"]],
                         wall_s=r["wall_s"])
    p, d = runs["plain"], runs["dp"]
    assert d["losses"] == p["losses"], (d["losses"], p["losses"])
    assert d["launches"] == p["launches"], d["launches"]
    assert _same_checkpoints(d["save"], p["save"])
    for stage in p["launches"]:
        assert stage[4] > 0 and stage[5] > 0, stage
        assert sum(stage) == stage[4] + stage[5], stage
    assert all(math.isfinite(v) for pair in p["losses"] for h in pair
               for v in h), p["losses"]
    out = dict(cancer=dict(losses=p["losses"], launches=p["launches"],
                           wall_s_dp=d["wall_s"], wall_s_plain=p["wall_s"]))
    print(f"accum 30b [{card}]: train_Cancer_wFT --grad-accum-steps "
          f"{ACCUM_K} --allow-microbatch-contrastive under 'pallas', with "
          f"--data-parallel (group of one) and without: the same bits, "
          f"losses {p['losses']}, launches by stage {p['launches']}; "
          f"{d['wall_s']:.1f} s (without: {p['wall_s']:.1f} s)", flush=True)

    wandb, save = StandInWandb(), os.path.join(tmp, "wandb_IEDB")
    real = sys.modules.get("wandb")
    sys.modules["wandb"] = wandb
    try:
        run_entry(train_IEDB_wFT, _with_flags(
            entry["argv"], save, "--num-epochs", "1", "--wandb-username",
            "smoke"))
    finally:
        if real is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = real
    names = [c[0] for c in wandb.calls]
    assert names[0] == "init" and names[-1] == "finish", names
    assert names.count("init") == names.count("finish") == 1, names
    assert wandb.calls[0][1]["entity"] == "smoke", wandb.calls[0]
    jsonl = [f for f in os.listdir(save) if f.endswith(".metrics.jsonl")]
    with open(os.path.join(save, jsonl[0])) as fh:
        lines = [json.loads(line) for line in fh]
    logged = [json.loads(json.dumps({
        k: float(v) if hasattr(v, "__float__") else v
        for k, v in c[1].items()})) for c in wandb.calls[1:-1]]
    assert len(lines) == len(logged) > 0, (len(lines), len(logged))
    assert json.dumps(logged) == json.dumps(lines)
    out["wandb"] = dict(calls=len(wandb.calls), jsonl_lines=len(lines))
    print(f"accum 30b [{card}]: train_IEDB_wFT --wandb-username with a "
          f"stand-in wandb: init, {len(lines)} logs (every JSONL line), "
          "finish", flush=True)
    return out


def check_augmented(tmp: str, entry: dict, ds) -> dict:
    """Phase 28b (d): train_IEDB_wFT --device-data --self-supervision
    --sequence-pad-count 5 --structure-pad-count 5 --aggregation mega twice
    (finite losses, the same bits), and every augmented batch of one epoch
    of its train pipeline held on the card against the plain gather of
    the same rows and the draws of its generator."""
    from immunostruct_tpu_torch.cli import train_IEDB_wFT
    from immunostruct_tpu_torch.config import Config
    from immunostruct_tpu_torch.data.dataset import seeded_split
    from immunostruct_tpu_torch.data.device_augment import (
        augment_batch, draw_batch,
    )
    from immunostruct_tpu_torch.data.device_pipeline import (
        DevicePipeline, gather_batch,
    )

    pad = 5
    argv = ["--model", "HybridModelv2_SSL", "--full-sequence",
            "--sequence-loss", "--aggregation", "mega", "--compute-dtype",
            "bfloat16", "--batch-size", str(B), "--num-epochs", "1",
            "--device", "cuda", "--seed", "1", "--device-data",
            "--self-supervision", "--sequence-pad-count", str(pad),
            "--structure-pad-count", str(pad), "--model-save-dir", "",
            "--graph-dir-IEDB", entry["corpus"][0],
            "--property-path-IEDB", entry["corpus"][1],
            "--hla-path", entry["corpus"][2]]
    runs = []
    for i in range(2):
        save = os.path.join(tmp, f"ssl_{i}")
        runs.append((save, run_entry(train_IEDB_wFT,
                                     _with_flags(argv, save))))
    (save0, r0), (save1, r1) = runs
    assert [s["pipeline"] for s in r0["stages"]] == ["DevicePipeline"] * 2
    losses = _losses(r0["stages"])
    assert all(np.isfinite(v).all() for pair in losses for v in pair), losses
    assert losses == _losses(r1["stages"]), (losses, _losses(r1["stages"]))
    assert _same_checkpoints(save0, save1)
    assert r0["launches"][0] > 0 and r0["launches"][1] > 0, r0["launches"]

    # every batch of one epoch of the pipeline the entry point trains on
    cfg = Config(device="cuda", batch_size=B, seed=1, full_sequence=True,
                 self_supervision=True, sequence_pad_count=pad,
                 structure_pad_count=pad)
    tr, _, _ = seeded_split(len(ds), (0.8, 0.1, 0.1), cfg.seed)
    pipe = DevicePipeline(ds, tr, split="train", binary=False, full=True,
                          config=cfg, ssl=True, device_augment=True)
    kw = pipe._augment_kw()
    rows_of = pipe._epoch_rows(0)
    checked = 0
    for step, batch in enumerate(pipe.epoch(0)):
        plain = gather_batch(pipe.corpus, rows_of[step])
        b, n, _ = plain.graph.node_feat.shape
        draws = draw_batch(pipe._generator(0, step), b, n, **kw)
        c0, c1 = plain.graph.coords, batch.graph.coords
        exact = "donot_use_mm_for_euclid_dist"
        d0 = torch.cdist(c0, c0, compute_mode=exact)
        d1 = torch.cdist(c1, c1, compute_mode=exact)
        f0, f1 = plain.graph.node_feat, batch.graph.node_feat
        real = f0.sum(-1) == 1
        ones = f1.sum(-1) == 20
        has_real = real.any(1)
        ssl_pos = ones.float().argmax(1)
        ssl_class = f0.gather(1, ssl_pos[:, None, None].expand(-1, 1, 20)
                              )[:, 0].argmax(-1)
        zeroed = (f1.sum(-1) == 0) & (f0.sum(-1) > 0)
        sel_n = torch.zeros_like(real).scatter_(
            1, torch.topk(draws["structure"], pad, dim=1).indices, True)
        seq0, seq1 = plain.seq_onehot, batch.seq_onehot
        sel_l = torch.zeros(seq0.shape[:2], dtype=torch.bool,
                            device=seq0.device)
        sel_l[:, :pipe.maskable_len] = torch.zeros_like(
            draws["sequence"], dtype=torch.bool).scatter_(
            1, torch.topk(draws["sequence"], pad, dim=1).indices, True)
        j = torch.zeros(21, device=seq0.device)
        j[20] = 1
        checks = torch.stack([
            # the rotation keeps every pairwise CA distance (f32 rounding)
            (d1 - d0).abs().max() <= 1e-5 * c0.abs().max() + 1e-6,
            # one all-ones row a graph with a real residue, none otherwise
            (ones.sum(1) == has_real.long()).all(),
            # its class in aux_residue (0 without a real residue)
            (batch.aux_residue == torch.where(has_real, ssl_class, 0)).all(),
            # the zeroed rows: the drawn positions, never the SSL row
            (zeroed == (sel_n & (f0.sum(-1) > 0) & ~ones)).all(),
            (zeroed.sum(1) <= pad).all(),
            # exactly `pad` 'J' positions, drawn inside the HLA region
            (sel_l.sum(1) == pad).all(),
            (seq1[sel_l] == j).all(),
            (seq1[~sel_l] == seq0[~sel_l]).all(),
        ])
        assert bool(checks.all()), (step, checks.tolist())
        checked += 1
    assert checked == len(pipe)
    # the per-step path makes no host sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen = pipe._generator(0, 0)
        augment_batch(gather_batch(pipe.corpus, rows_of[0]), gen, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    row = dict(batches_checked=checked, losses=losses,
               launches=r0["launches"], wall_s=[r0["wall_s"], r1["wall_s"]])
    print("augmented device data:", json.dumps(row), flush=True)
    return row


# --------------------------------------------------------------------------
# phase 31: the captured programs against the eager path
# --------------------------------------------------------------------------

CAPTURED_STEPS = 20             # train steps a Trainer (1 eager, 19 graph)
CAPTURED_REQUESTS = 20          # requests a scorer
CAPTURED_TRACED = 5             # calls under torch.profiler


# read_counts()' kernels by their labels in utils/attribution.py
TRACE_LABELS = ("B1", "B2", "B3 fwd", "B3 bwd", "B8 scatter", "B8 gather",
                "B4", "B5a", "B5b", "B6", "B7")


def _traced(fn, wall_ms: float) -> dict:
    """``CAPTURED_TRACED`` calls of ``fn`` under torch.profiler: the
    device's busy time a call, its idle share against ``wall_ms`` (1 -
    busy/wall) and over the traced span (``attribution.occupancy``), the
    host's ATen calls a call; and the csrc kernels the trace names, by
    kernel, which must equal the launch counters' increments over the same
    calls (a replay's counts are the program's, not the wrappers')."""
    from immunostruct_tpu_torch.utils.attribution import (
        csrc_kernel, occupancy,
    )

    def window():
        start = []
        per_name, host, timeline = device_profile(
            fn, CAPTURED_TRACED, warmup=1,
            at_record=lambda: start.append(read_counts()))
        counted = tuple(a - z for a, z in zip(read_counts(), start[0]))
        traced = dict.fromkeys(TRACE_LABELS, 0)
        for name, (_, launches) in per_name.items():
            label = csrc_kernel(name)
            if label is not None:
                traced[label] += launches
        return per_name, host, timeline, tuple(traced.values()), counted

    per_name, host, timeline, traced, counted = window()
    retraced = None
    if traced != counted:
        # the tracer dropped one kernel's record (29 of 30 B1) in a long
        # process whose recording began without a warm-up; a graph that
        # stopped launching a kernel falls short in every window, so one
        # window more decides
        odd = {k: c for k, (_, c) in per_name.items()
               if c % CAPTURED_TRACED}
        print(f"captured 31: trace {traced} against the counters "
              f"{counted}; kernels whose count is no multiple of "
              f"{CAPTURED_TRACED}: {odd}", flush=True)
        retraced = dict(traced=traced, counted=counted)
        per_name, host, timeline, traced, counted = window()
    assert traced == counted, (traced, counted, retraced)
    busy = sum(t for t, _ in per_name.values()) / 1e3 / CAPTURED_TRACED
    occ = occupancy(timeline, CAPTURED_TRACED)
    return dict(device_busy_ms=busy, idle_share=max(0.0, 1.0 - busy / wall_ms),
                occupancy_idle_share=occ["idle_frac"],
                occupancy_span_ms=occ["span_ms"],
                device_ops_per_call=sum(c for _, c in per_name.values())
                / CAPTURED_TRACED, host_aten_calls=host["aten"],
                traced_launches=traced, counted_launches=counted,
                first_window=retraced)


def _memory_window():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def _memory_peaks(base) -> dict:
    torch.cuda.synchronize()
    return dict(peak_allocated_bytes=torch.cuda.max_memory_allocated()
                - base[0],
                peak_reserved_bytes=torch.cuda.max_memory_reserved()
                - base[1])


def captured_training(card: str) -> dict:
    """Phase 31a (module docstring)."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    batch = random_sample_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                device="cuda")
    runs = {}
    for kind, capture in (("captured", None), ("eager", False)):
        trainer, state = make_trainer("HybridModelv2", "mega",
                                      capture=capture)
        base = _memory_window()
        reset_counts()                  # every count to 0: the 20 steps
        losses, walls = [], []
        for _ in range(CAPTURED_STEPS):
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, batch, seed=0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        counts = read_counts()          # read just after them
        n = 6 * CAPTURED_STEPS
        assert counts == (n, n, 0, 0, 2 * n) + (0,) * 6, (kind, counts)
        program = trainer.train_program
        row = dict(launches=counts, losses=[float(v) for v in losses],
                   first_wall_ms=walls[:2], wall_ms_median=statistics.median(
                       walls[2:]), eager_calls=dict(program.eager_calls),
                   captures=program.captures, replays=program.replays,
                   capture_s=program.capture_seconds(),
                   **_memory_peaks(base))
        bits = dict(losses=torch.stack(losses),
                    params=[p.detach().clone()
                            for p in state.model.parameters()],
                    moments=[state.optimizer.state[p][k].clone()
                             for p in state.model.parameters()
                             for k in ("exp_avg", "exp_avg_sq")])
        row.update(_traced(lambda: trainer.train_step(state, batch, seed=0),
                           row["wall_ms_median"]))
        base = _memory_window()
        for i in range(5):
            trainer.eval_step(state.model, batch, 1, index=i)
        row["eval"] = dict(trainer.eval_program.eager_calls,
                           captures=trainer.eval_program.captures,
                           replays=trainer.eval_program.replays,
                           **_memory_peaks(base))
        runs[kind] = (row, bits)
        del trainer, state
    (cap, cap_bits), (eag, eag_bits) = runs["captured"], runs["eager"]
    assert (cap["captures"], cap["replays"]) == (1, CAPTURED_STEPS - 1), cap
    assert cap["eager_calls"] == {"first call": 1}, cap
    assert eag["eager_calls"] == {"asked": CAPTURED_STEPS}, eag
    assert torch.equal(cap_bits["losses"], eag_bits["losses"])
    for part in ("params", "moments"):
        differ = sum(int((a != b).sum()) for a, b in zip(cap_bits[part],
                                                         eag_bits[part]))
        assert differ == 0, (part, differ)
    assert cap["losses"][-1] < cap["losses"][0], cap["losses"]
    for kind, row in (("captured", cap), ("eager", eag)):
        print(f"captured 31 [{card}]: 'mega' train step B=128 E=2560 bf16, "
              f"{kind}: " + json.dumps(row), flush=True)
    return dict(captured=cap, eager=eag)


def _in_turn(calls: dict, n: int) -> dict:
    """``n`` calls of each of ``calls`` (name -> fn returning numpy) in
    turn: their walls (ms) and results."""
    walls = {k: [] for k in calls}
    out = {k: [] for k in calls}
    for _ in range(n):
        for k, fn in calls.items():
            t0 = time.perf_counter()
            out[k].append(fn())
            walls[k].append((time.perf_counter() - t0) * 1e3)
    return walls, out


def captured_serving(card: str, scorer, requests, artifacts: dict) -> list:
    """Phase 31b (module docstring)."""
    from immunostruct_tpu_torch.serving import (
        ArtifactScorer, Scorer, request_to_args,
    )
    from immunostruct_tpu_torch.utils.export import REQUEST_KEYS, load_exported

    rows = []
    for label, b, path in (requests[0], requests[2]):
        args = request_to_args(path, "cuda", scorer.model)
        pair = {kind: Scorer(scorer.model, device="cuda",
                             compute_dtype=scorer.compute_dtype,
                             aggregation="mega", seed=scorer.seed,
                             capture=capture)
                for kind, capture in (("captured", None), ("eager", False))}
        reset_counts()                  # every count to 0: the requests
        walls, out = _in_turn({k: functools.partial(s, *args)
                               for k, s in pair.items()}, CAPTURED_REQUESTS)
        counts = read_counts()          # read just after them
        assert counts == (12 * CAPTURED_REQUESTS,) + (0,) * 10, counts
        rows.append(_served_row(card, f"Scorer {label}", pair, walls, out,
                                lambda s: (lambda: s(*args))))
    for label, a in artifacts.items():
        with np.load(a["request"]) as z:
            tensors = [torch.from_numpy(z[k]).cuda() for k in REQUEST_KEYS]
        pair = {kind: ArtifactScorer(load_exported(a["path"], "cuda"),
                                     capture)
                for kind, capture in (("captured", None), ("eager", False))}
        reset_counts()
        walls, out = _in_turn({k: functools.partial(s, *tensors)
                               for k, s in pair.items()}, CAPTURED_REQUESTS)
        counts = read_counts()
        assert counts == (12 * CAPTURED_REQUESTS,) + (0,) * 10, counts
        eager_scorer = Scorer(scorer.model, device="cuda",
                              compute_dtype=scorer.compute_dtype,
                              aggregation="mega", seed=scorer.seed,
                              capture=False)
        want = eager_scorer(*request_to_args(a["request"], "cuda",
                                             scorer.model))
        assert np.array_equal(out["captured"][0], want), label
        rows.append(_served_row(card, f"artifact ({label}) B="
                                f"{tensors[0].shape[0]} E=2560", pair, walls,
                                out,
                                lambda s: (lambda: s(*tensors))))
    return rows


def _served_row(card, work, pair, walls, out, call) -> dict:
    """Hold the captured calls to the eager ones bit for bit and print
    phase 31b's row of ``work``."""
    for got, want in zip(out["captured"], out["eager"]):
        assert np.array_equal(got, want), work
    assert np.isfinite(out["captured"][0]).all(), work
    program = pair["captured"].program
    assert (program.captures, program.replays) == (
        1, CAPTURED_REQUESTS - 1), (work, program.captures, program.replays)
    row = dict(work=work, capture_s=program.capture_seconds(),
               replays=program.replays)
    for kind, s in pair.items():
        wall = statistics.median(walls[kind][2:])
        row[kind] = dict(wall_ms_median=wall, first_wall_ms=walls[kind][:2],
                         **_traced(call(s), wall))
    print(f"captured 31 [{card}]: served {work} bf16: "
          + json.dumps(row), flush=True)
    return row


# --------------------------------------------------------------------------
# the eager paths against other checkouts (python3 chip_smoke.py
# --eager-walls DIR ...)
# --------------------------------------------------------------------------

EAGER_FORWARDS = (0, 2)         # REQUESTS: B=128 and B=1 at E=2560


@contextlib.contextmanager
def direct_launches():
    """Within the block the four kernel wrappers (B1, B3's forward, B8's
    scatter and gather) call their ops' CUDA implementations themselves,
    not through the dispatcher, as the wrappers launched before they were
    ops (counted as ever)."""
    from immunostruct_tpu_torch.ops import edge, mega, segment

    swaps = ((mega, "_MEGA_FWD_OP", mega._mega_fwd_cuda),
             (edge, "_EDGE_FWD_OP", edge._edge_fwd_cuda),
             (segment, "_SCATTER_OP", segment._scatter_cuda),
             (segment, "_GATHER_OP", segment._gather_cuda))
    ops = [getattr(module, name) for module, name, _ in swaps]
    for module, name, direct in swaps:
        setattr(module, name, direct)
    try:
        yield
    finally:
        for (module, name, _), op in zip(swaps, ops):
            setattr(module, name, op)


def eager_walls() -> dict:
    """The eager paths' walls with the package this process imports:
    the served 'mega' forward (``Scorer`` on ``write_example``'s request,
    ending in the copy to the host) at B=128 and B=1, median of 30 calls
    after 5, and a 'pallas' and a 'fused' train step at B=128, E=2560,
    median of 17 steps after 3. Where the package's kernels are ops
    (``direct_launches`` finds them), each is timed through the ops and
    with ``direct_launches`` in turn: {work: {"ops" / "direct" / "as is":
    ms}}."""
    import immunostruct_tpu_torch
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch
    from immunostruct_tpu_torch.ops import _build, segment
    from immunostruct_tpu_torch.serving import request_to_args

    _build.build()
    kinds = ({"ops": contextlib.nullcontext, "direct": direct_launches}
             if hasattr(segment, "_SCATTER_OP")
             else {"as is": contextlib.nullcontext})

    def in_turn(fn, calls, warm):
        ms = {kind: [] for kind in kinds}
        for k in range(warm + calls):
            for kind, ctx in kinds.items():
                with ctx():
                    t0 = time.perf_counter()
                    fn()
                    if k >= warm:
                        ms[kind].append((time.perf_counter() - t0) * 1e3)
        return {kind: statistics.median(v) for kind, v in ms.items()}

    walls = dict(package=os.path.dirname(immunostruct_tpu_torch.__file__))
    tmp = tempfile.mkdtemp(prefix="eager_")
    try:
        requests = write_requests(tmp)
        scorer = full_width_scorer()
        for i in EAGER_FORWARDS:
            label, _, path = requests[i]
            args = request_to_args(path, scorer.device, scorer.model)
            walls[f"forward {label} mega"] = in_turn(lambda: scorer(*args),
                                                     30, 5)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    batch = random_sample_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                device="cuda")
    for agg in ("pallas", "fused"):
        trainer, state = make_trainer("HybridModelv2", agg)

        def step():
            trainer.train_step(state, batch, seed=0)
            torch.cuda.synchronize()

        walls[f"train step B=128 E=2560 {agg}"] = in_turn(step, 17, 3)
        del trainer, state
    return walls


def compare_eager(roots) -> int:
    """``eager_walls`` of each checkout root in ``roots`` and of this one,
    each in a fresh process, in the order roots, this, this, roots
    reversed; prints each reading and, per checkout, the mean of its two
    beside the card line."""
    order = [*roots, ROOT, ROOT, *reversed(roots)]
    readings = {}
    for root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--eager-walls-of",
             root], cwd=root, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=root))
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        walls = json.loads(proc.stdout.strip().splitlines()[-1])
        assert os.path.realpath(walls.pop("package")) == os.path.realpath(
            os.path.join(root, "immunostruct_tpu_torch")), walls
        print("eager walls:", json.dumps(dict(checkout=root, **walls)),
              flush=True)
        readings.setdefault(root, []).append(walls)
    print("eager walls, mean of two:", json.dumps({
        root: {work: {kind: statistics.mean(w[work][kind] for w in runs)
                      for kind in runs[0][work]}
               for work in runs[0]}
        for root, runs in readings.items()}))
    print(card_line())
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--eager-walls"]:
        sys.path.insert(0, ROOT)
        return compare_eager([os.path.abspath(d) for d in sys.argv[2:]])
    if sys.argv[1:2] == ["--eager-walls-of"]:
        sys.path.insert(0, sys.argv[2])     # that checkout's package
        print(json.dumps(eager_walls()))
        return 0
    sys.path.insert(0, ROOT)
    card = card_line()
    print(f"card: {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s))", flush=True)
    # the clinical cohort (phases 21 and 24) is written by a process of its
    # own while the serving and training phases run
    clinical_root = tempfile.mkdtemp(prefix="clinical_")
    clinical = ClinicalCorpus(clinical_root)
    try:
        return run_phases(card, clinical)
    finally:
        clinical.stop()
        shutil.rmtree(clinical_root, ignore_errors=True)


def run_phases(card: str, clinical: ClinicalCorpus) -> int:
    from immunostruct_tpu_torch.ops import (
        _build, edge, fused_layer, mega, segment, stack,
    )

    t0 = time.perf_counter()
    _build.build()                      # one nvcc per source, in parallel
    mega._kernel_libs()
    edge._kernel_libs()
    segment._lib()
    stack._lib()
    fused_layer._lib()
    build_s = time.perf_counter() - t0
    sources = len(list(_build.CSRC.glob("*.cu")))
    assert sources == 10, sources
    print(f"kernel build + load (all {sources} sources): {build_s:.1f} s",
          flush=True)

    clock0 = time.perf_counter()

    def clock(label):       # where the run's time goes, for PERF.md §4
        print(f"phase clock: {label} at {time.perf_counter() - clock0:.1f} s "
              "after the build", flush=True)

    fwd_rows = check_fwd_kernel()
    tail_rows = check_tail_kernel()
    check_edge_mega_grads()
    edge_rows = check_edge_kernels()
    check_fused_layer_grads()
    segment_rows = check_segment_kernels()
    check_pallas_layer_grads()
    paired_rows = check_paired_kernel()
    db_rows = check_tail_db_kernel()
    nodes_rows = check_tail_nodes_kernel()
    stack_rows = check_stack_kernel()
    b7_rows = check_b7_kernel()
    clock("kernel checks (4-14a)")
    check_sweep(card)
    clock("sweep (14b)")
    clinical.start()
    scorer = full_width_scorer()
    with tempfile.TemporaryDirectory() as tmp:
        requests = write_requests(tmp)
        served, serving_counts = check_serving(scorer, requests)
        b7_served, b7_counts = check_serving(fused_stack_scorer(scorer),
                                             requests, kernel=B7_INDEX)
        train_rows, train_counts = check_training()
        clock("serving and first steps (15-16)")
        same_bits_rows = check_same_bits()
        onehot_row = check_onehot_training()
        comp_row, comp_counts = check_comparative()
        fused_rows, fused_counts = check_fused_training(train_rows)
        clock("training paths (16a-18)")
        entry, entry_operands = check_entry_point(tmp)
        edge_rows += check_entry_edge_kernels(entry_operands)
        pallas_rows, pallas_counts = check_pallas_training(train_rows)
        cancer, cancer_operands = check_cancer_entry_point(
            tmp, clinical.paths())
        segment_rows += check_entry_segment_kernels(cancer_operands)
        inference_rows = check_batch_inference(entry, cancer, tmp)
        clock("entry points (19-21a)")
        featurized = check_featurize(tmp, entry)
        curriculum, curriculum_operands = check_curriculum(
            tmp, featurized, entry, cancer)
        b1_b2_b8 = check_curriculum_kernels(curriculum_operands)
        fwd_rows += b1_b2_b8[0]
        tail_rows += b1_b2_b8[1]
        segment_rows += b1_b2_b8[2]
        clinical_row = check_clinical(tmp, clinical.paths(), curriculum)
        clock("PDBs to p-values (22-24)")
        variant_firsts = check_variant_first_steps()
        race_rows, race_counts = check_race()
        variant_served = check_variant_serving(scorer)
        paired_sync = check_paired_no_sync(scorer)
        clock("variants and race (25-27a)")
        artifact_rows, artifact_counts, artifact_paths, op_rows = \
            check_artifacts(scorer, requests, tmp)
        clock("artifacts (27b)")
        phase28 = profile_forwards(scorer, requests)
        artifact_profile = profile_artifacts(scorer, artifact_paths)
        phase28 += profile_training()
        clock("profiler (28)")
        profiled_steps = check_profile_step(tmp, phase28)
        clock("profile_step (28a)")
        device_data = check_device_data(tmp, entry, cancer)
        clock("device data (28b)")
        t29 = time.perf_counter()
        parallel = dict(
            entry_points=check_parallel_entry_points(tmp, entry, cancer,
                                                     card),
            data=check_data_parallel(card), model=check_model_parallel(card))
        parallel["phase_s"] = time.perf_counter() - t29
        print(f"parallel 29 [{card}]: phase 29 took "
              f"{parallel['phase_s']:.1f} s", flush=True)
        clock("parallelism (29)")
        accumulated = check_accumulated_twin(card)
        accumulated.update(check_accumulated_entry_points(tmp, entry, cancer,
                                                          card))
        clock("accumulation and wandb (30)")
        captured = dict(training=captured_training(card),
                        serving=captured_serving(card, scorer, requests,
                                                 artifact_paths))
        clock("captured programs (31)")

    def pick(rows, **want):
        return next(r for r in rows if r["E"] == 2560 and r["F"] == 64
                    and r["dtype"] == "bfloat16" and r.get("B", B) == B
                    and r.get("shapes", "bench") == "bench"
                    and all(r[k] == v for k, v in want.items()))

    for r, r7 in zip(served, b7_served):
        print(f"latency [{card}]: {r['request']}: median forward "
              f"{r['median_forward_ms']:.3f} ms, median HTTP round trip "
              f"{r['median_http_wall_ms']:.3f} ms; with fused_stack (B7) "
              f"{r7['median_forward_ms']:.3f} ms, round trip "
              f"{r7['median_http_wall_ms']:.3f} ms")
    for r in b7_rows:
        print(f"kernel  [{card}]: B7 B={r['B']} E={r['E']} F={r['F']} "
              f"{r['dtype']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), device {r['device_ms']:.4f} ms, cluster "
              f"{r['cluster']}, {r['smem_per_cta']} B shared memory a CTA")
    for r in same_bits_rows:
        print(f"repeat  [{card}]: {r['aggregation']}/{r['mega_variant']} "
              f"B={r['B']} E={r['E']} {r['steps']} steps trained twice: "
              f"{r['entries_that_differ']} entries differ")
    for agg, v in onehot_row["peak_memory"].items():
        print(f"memory  [{card}]: train step B=128 E=2560 bf16 {agg}: peak "
              f"{v['max_memory_allocated_bytes']} B allocated, step "
              f"{v['step_ms']:.3f} ms")
    for label, r in inference_rows.items():
        print(f"infer   [{card}]: infer_IEDB_or_Cancer {label}: {r['rows']} "
              f"rows, {r['wall_s_auto']:.3f} s under auto, "
              f"{r['wall_s_onehot']:.3f} s under onehot")
    print(f"paired  [{card}]: forward and step without a host sync, "
          f"launches {list(paired_sync['launches'])}")
    for r in artifact_profile:
        t = r["in_turn"]
        print(f"profile [{card}]: artifact ({t['artifact']}) B={t['B']} "
              f"E=2560 'mega': wall {t['artifact_wall_ms_median']:.3f} ms "
              f"eager (the captured Scorer in turn "
              f"{t['scorer_wall_ms_median']:.3f} ms), device busy {r['device_busy_ms']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}, {r['device_ops_per_call']:.0f} device "
              f"ops a call")
    for r in op_rows:
        if "host_us_op" in r:
            print(f"op      [{card}]: {r['op']} bf16 B=2 E=256: host "
                  f"{r['host_us_op']:.1f} us a call through the op, "
                  f"{r['host_us_direct']:.1f} us the direct launch")
    for r in artifact_rows:
        if r["int8"]:
            print(f"export  [{card}]: artifact ({r['artifact']}) int8 "
                  f"B={r['B']} E={r['E']} {r['aggregation']}: export "
                  f"{r['export_s']:.3f} s, {r['bytes']} B, max |prob diff| "
                  f"vs (a) {r['max_abs_prob_diff_vs_a']:.3e}, parameters "
                  f"{r['quantized_size_bytes'][0]} B f32, "
                  f"{r['quantized_size_bytes'][1]} B int8")
            continue
        print(f"export  [{card}]: artifact ({r['artifact']}) B={r['B']} "
              f"E={r['E']} {r['aggregation']}: export {r['export_s']:.3f} s,"
              f" {r['bytes']} B; median forward {r['median_forward_ms']:.3f}"
              f" ms (eager {r['eager_median_forward_ms']:.3f} ms), median "
              f"HTTP round trip {r['median_http_ms']:.3f} ms (eager "
              f"{r['eager_median_http_ms']:.3f} ms), launches a call "
              f"{r['launches_per_call']}, the eager server's bits")
    for r in train_rows:
        print(f"train   [{card}]: B=128 E={r['E']} bf16: median step "
              f"{r['median_step_ms_mega']:.3f} ms 'mega' "
              f"({r['pmhc_per_s_mega']:.0f} pMHC/s), "
              f"{r['median_step_ms_scatter']:.3f} ms 'scatter' "
              f"({r['pmhc_per_s_scatter']:.0f} pMHC/s)")
    for r in fused_rows:
        print(f"train   [{card}]: B=128 E={r['E']} bf16: median step "
              f"{r['median_step_ms_fused']:.3f} ms 'fused' "
              f"({r['pmhc_per_s_fused']:.0f} pMHC/s)")
    print(f"twins   [{card}]: B=128 E=2560 bf16: median step "
          f"{comp_row['median_step_ms']:.3f} ms")
    for r in pallas_rows:
        print(f"train   [{card}]: B=128 E={r['E']} bf16: median step "
              f"{r['median_step_ms_pallas']:.3f} ms 'pallas' "
              f"({r['pmhc_per_s_pallas']:.0f} pMHC/s)")
    for ep in entry["epochs"]:
        print(f"entry   [{card}]: train_IEDB_wFT --aggregation fused, "
              f"N={entry['N']} E={entry['E']}, {ep['stage']} epoch "
              f"{ep['epoch']}: {ep['epoch_s']:.3f} s, "
              f"{ep['pmhc_per_s']:.0f} pMHC/s")
    for ep in cancer["epochs"]:
        print(f"entry   [{card}]: train_Cancer_wFT --aggregation pallas, "
              f"N={cancer['N']}, {ep['stage']} epoch {ep['epoch']} "
              f"({ep['steps']} steps): {ep['epoch_s']:.3f} s, "
              f"{ep['pmhc_per_s']:.0f} pMHC/s")
    for label in ("native", "numpy"):
        f = featurized[label]
        print(f"feature [{card}]: featurize {label} (host CPU): "
              f"{featurized['structures']} structures in {f['wall_s']:.3f} s,"
              f" {f['structures_per_s']:.1f} structures/s")
    for ep in curriculum["epochs"]:
        print(f"entry   [{card}]: train_curriculum --aggregation mega, "
              f"{ep['stage']} epoch {ep['epoch']} ({ep['steps']} steps): "
              f"{ep['epoch_s']:.3f} s, {ep['pmhc_per_s']:.0f} pMHC/s")
    for label, rate in clinical_row["rows_per_s"].items():
        print(f"clinic  [{card}]: infer_clinical_only {label}: "
              f"{CLINICAL_ROWS} rows scored in "
              f"{clinical_row['scoring_s'][label]:.3f} s, {rate:.0f} rows/s "
              f"(entry point {clinical_row['wall_s'][label]:.3f} s)")
    for r in segment_rows:
        print(f"kernel  [{card}]: B8 {r['kernel']} ({r['shapes']}) B={r['B']} "
              f"E={r['E']} N={r['N']} C={r['C']} {r['dtype']}: kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}, host "
              f"{r['host_us']:.1f} us a call), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms (device "
              f"{r['library_device_ms']:.4f}, host {r['library_host_us']:.1f}"
              f" us), bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for r in race_rows:
        for v, t in r["race"].items():
            print(f"race    [{card}]: B=128 E={r['E']} bf16 paired batch: "
                  f"{v} p50 {t['p50_ms']:.3f} ms (best {t['best_ms']:.3f}, "
                  f"windows {t['windows_ms']}), loss {t['loss0']:.4f} -> "
                  f"window medians {t['windows_loss']}, least "
                  f"{t['min_loss']:.4f}")
    for r in variant_firsts:
        print(f"variant [{card}]: first step E={r['E']} {r['variant']}: "
              f"loss rel diff {r['loss_rel_diff']:.2e}, worst gradient "
              f"{r['grad_worst_in_tol']:.3f} of its bound")
    for r in variant_served:
        print(f"serve   [{card}]: B=128 E=2560 {r['variant']}: median "
              f"forward {r['median_forward_ms']:.3f} ms ('hybrid' "
              f"{r['median_forward_ms_hybrid']:.3f} ms), prob err "
              f"{r['max_abs_prob_err_vs_scatter']:.2e}")
    for kind, rows in (("B4", paired_rows), ("B5a", db_rows),
                       ("B5b", nodes_rows), ("B6", stack_rows)):
        for r in rows:
            smem = ("" if "smem_per_cta" not in r else
                    f", {r['smem_per_cta']} B shared memory a CTA")
            if "ctas_per_sm" in r:
                smem += f", {r['ctas_per_sm']} CTAs an SM"
            print(f"kernel  [{card}]: {kind} B={r.get('B', B)} E={r['E']} "
                  f"F={r['F']} {r['dtype']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){smem}")
    for kind, rows in (("B1", fwd_rows), ("B2", tail_rows),
                       ("B3", edge_rows)):
        for r in rows:
            label = f"{kind} {r['kernel']}" if kind == "B3" else kind
            bare = ("" if kind != "B1" else
                    f"; without residuals {r['bound_ms_without_residuals']:.4f}"
                    f" ms ({r['bound_by_without_residuals']})")
            if "smem_per_cta" in r:
                bare += f", {r['smem_per_cta']} B shared memory a CTA"
            if "ctas_per_sm" in r:
                bare += f", {r['ctas_per_sm']} CTAs an SM"
            if "device_ms" in r:
                bare += f", device {r['device_ms']:.4f} ms"
            where = "" if kind == "B3" else f" ({r['shapes']})"
            nodes = f" N={r['N']}" if "N" in r else ""
            print(f"kernel  [{card}]: {label}{where} B={r.get('B', B)}{nodes}"
                  f" E={r['E']} F={r['F']} "
                  f"{r['dtype']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){bare}")

    for kind in ("captured", "eager"):
        r = captured["training"][kind]
        print(f"captured 31 [{card}]: 'mega' train step B=128 E=2560 bf16 "
              f"{kind}: median wall {r['wall_ms_median']:.3f} ms, device "
              f"busy {r['device_busy_ms']:.3f} ms, idle share "
              f"{r['idle_share']:.4f} (occupancy of back-to-back steps "
              f"{r['occupancy_idle_share']:.4f}), {r['host_aten_calls']:.0f} "
              f"host aten calls a step, capture {r['capture_s']:.3f} s, "
              f"peak allocated {r['peak_allocated_bytes']} B, reserved "
              f"{r['peak_reserved_bytes']} B, replays {r['replays']}, "
              f"launches {list(r['launches'])}; over {CAPTURED_TRACED} "
              f"traced steps the trace names {list(r['traced_launches'])}"
              f", the counters {list(r['counted_launches'])}")
    for r in captured["serving"]:
        c, e = r["captured"], r["eager"]
        print(f"captured 31 [{card}]: served {r['work']} bf16: median wall "
              f"{c['wall_ms_median']:.3f} ms captured, {e['wall_ms_median']:.3f}"
              f" ms eager; device busy {c['device_busy_ms']:.3f} / "
              f"{e['device_busy_ms']:.3f} ms; idle share "
              f"{c['idle_share']:.4f} / {e['idle_share']:.4f} (occupancy "
              f"{c['occupancy_idle_share']:.4f} / "
              f"{e['occupancy_idle_share']:.4f}); host aten calls "
              f"{c['host_aten_calls']:.0f} / {e['host_aten_calls']:.0f}; "
              f"capture {r['capture_s']:.3f} s, replays {r['replays']}; over "
              f"{CAPTURED_TRACED} traced calls the trace names "
              f"{list(c['traced_launches'])} captured, "
              f"{list(e['traced_launches'])} eager, as the counters")
    mfu = profiled_steps["mfu"]
    for label, r in profiled_steps["runs"].items():
        same = ("" if "ratio_to_phase28" not in r else
                f", {r['ratio_to_phase28']:.4f} of phase 28's device-busy "
                f"{r['phase28_device_busy_ms']:.3f} ms")
        print(f"profile [{card}]: profile_step {label} 'mega': rows sum "
              f"{r['device_total_ms']:.3f} ms a step{same}; top "
              f"{[[round(ms, 3), lab] for ms, lab in r['rows'][:4]]}")
    print(f"profile [{card}]: 'mega' train step B=128 E=2560 idle share: "
          f"occupancy (profile_step, with_stack) "
          f"{mfu['idle_share_occupancy']:.3f}; phase 28 (1 - busy/wall) "
          f"{mfu['idle_share_phase28']:.3f}")
    if mfu["peak_tflops_bf16"] is None:
        print(f"mfu     [{card}]: the card is not in utils/flops.py's table; "
              f"analytic {mfu['analytic_tflop_per_step']:.4f} TFLOP a step")
    else:
        print(f"mfu     [{card}]: 'mega' train step B=128 E=2560 bf16: "
              f"analytic {mfu['analytic_tflop_per_step']:.4f} TFLOP a step "
              f"({mfu['params']} parameters), ATen ops executed "
              f"{mfu['executed_aten_tflop_per_step']:.4f} TFLOP "
              f"(FlopCounterMode; the csrc kernels count nothing); MFU "
              f"{mfu['mfu_of_wall']:.4%} of {mfu['peak_tflops_bf16']:.0f} "
              f"TFLOP/s at the {mfu['wall_ms']:.3f} ms wall, "
              f"{mfu['mfu_of_device_time']:.4%} at the "
              f"{mfu['device_busy_ms']:.3f} ms device time")
    dd = device_data
    c = dd["corpus"]
    print(f"data    [{card}]: --device-data budget "
          f"{c['budget_bytes'][0] / (1 << 30):.2f} GiB a dataset, "
          f"{c['budget_bytes'][1] / (1 << 30):.2f} GiB in all; phase 19's "
          f"corpus ({c['rows']} rows, {c['graphs']} graphs): estimate "
          f"{c['estimate_bytes']} B = uploaded nbytes, memory_allocated grew "
          f"{c['memory_allocated_growth']} B")
    for name, runs in dd["turns"].items():
        for kind, r in runs:
            print(f"data    [{card}]: {name} entry point, {kind} pipeline: "
                  f"wall {r['wall_s']:.3f} s, epochs (s) "
                  f"{[round(t, 4) for t in r['epochs']]}")
    for r in dd["epoch_occupancy"]:
        print(f"data    [{card}]: {r['work']} epoch ({r['steps']} steps) on "
              f"the {r['pipeline']}: traced span {r['span_ms']:.3f} ms, "
              f"device busy {r['busy_ms']:.3f} ms, idle share "
              f"{r['idle_share']:.4f} (occupancy)")
    ref = dd["reference_scale"]
    print(f"data    [{card}]: reference scale {ref['rows']} rows (N={ref['N']}"
          f", E={ref['E']}, L={ref['L']}): {ref['bytes']} B "
          f"({ref['bytes_per_row']:.0f} B a row) uploaded in "
          f"{ref['upload_s']:.3f} s; a B=128 gather_batch {ref['gather_device_us']:.1f}"
          f" us on the device, {ref['gather_host_us']:.1f} us on the host; "
          f"the host pipeline's assembly and copy {ref['host_pipeline_us']:.1f}"
          f" us a batch")
    aug = dd["augmented"]
    print(f"data    [{card}]: --device-data --self-supervision, 5+5 masks, "
          f"'mega': {aug['batches_checked']} augmented batches held, the same"
          f" bits twice, no host sync in gather+augment")

    launches = dict(serving=serving_counts, serving_b7=b7_counts,
                    train=train_counts,
                    comparative=comp_counts, train_fused=fused_counts,
                    entry_point=entry["launches"], train_pallas=pallas_counts,
                    entry_point_cancer=cancer["launches"], race=race_counts,
                    curriculum=curriculum["launches"],
                    clinical=clinical_row["launches_mega"],
                    artifact_serving=artifact_counts,
                    profile_step=mfu["launches"]["train"],
                    device_data_ssl=aug["launches"],
                    twin_accumulated=accumulated["bfloat16"]["launches"],
                    captured_train=captured["training"]["captured"][
                        "launches"])
    b1, b2 = pick(fwd_rows), pick(tail_rows)
    b3f, b3b = pick(edge_rows, kernel="fwd"), pick(edge_rows, kernel="bwd")
    b8s, b8g = (next(r for r in segment_rows if r["kernel"] == kind
                     and r["shapes"] == "bench" and r["E"] == 2560
                     and r["dtype"] == "bfloat16")
                for kind in ("scatter", "gather"))
    b4, b5a, b5b = pick(paired_rows), pick(db_rows), pick(nodes_rows)
    b6 = next(r for r in stack_rows if r["E"] == 2560 and r["B"] == B
              and r["dtype"] == "bfloat16")
    b7 = pick(b7_rows)

    def kernel_record(name, source, replaces, index, main_count, row, rows,
                      ms_key="ms"):
        return {
            "name": name, "route": "cuda",
            "source": f"immunostruct_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": main_count,
            "launches_by_path": {k: v[index] for k, v in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row[ms_key], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        }

    # no single PyTorch call computes B1-B7 (B7 a whole EGNN layer): their
    # library_ms is null; B8's is index_add_ (scatter) and index_select
    # (gather)
    record = {"kernels": [
        kernel_record("egnn_mega_fwd", "egnn_mega_fwd.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:226", 0,
                      train_counts[0], b1, fwd_rows,
                      ms_key="ms_with_residuals"),
        kernel_record("egnn_tail_bwd", "egnn_tail_bwd.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:370", 1,
                      train_counts[1], b2, tail_rows),
        kernel_record("egnn_edge_fwd", "egnn_edge_fwd.cu",
                      "immunostruct_tpu/ops/pallas_edge.py:152", 2,
                      entry["launches"][2], b3f,
                      [r for r in edge_rows if r["kernel"] == "fwd"]),
        kernel_record("egnn_edge_bwd", "egnn_edge_bwd.cu",
                      "immunostruct_tpu/ops/pallas_edge.py:168", 3,
                      entry["launches"][3], b3b,
                      [r for r in edge_rows if r["kernel"] == "bwd"]),
        kernel_record("segment_scatter", "segment.cu",
                      "immunostruct_tpu/ops/experimental/pallas_segment.py:60",
                      4, cancer["launches"][4], b8s,
                      [r for r in segment_rows if r["kernel"] == "scatter"]),
        kernel_record("segment_gather", "segment.cu",
                      "immunostruct_tpu/ops/experimental/pallas_segment.py:79",
                      5, cancer["launches"][5], b8g,
                      [r for r in segment_rows if r["kernel"] == "gather"]),
        kernel_record("egnn_mega_paired_fwd", "egnn_mega_paired_fwd.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:303", 6,
                      race_counts[6], b4, paired_rows),
        kernel_record("egnn_tail_bwd_db", "egnn_tail_bwd_db.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:501", 7,
                      race_counts[7], b5a, db_rows),
        kernel_record("egnn_tail_bwd_nodes", "egnn_tail_bwd_nodes.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:525", 8,
                      race_counts[8], b5b, nodes_rows),
        kernel_record("egnn_stack_fwd", "egnn_stack_fwd.cu",
                      "immunostruct_tpu/ops/experimental/pallas_stack.py:98",
                      9, race_counts[9], b6, stack_rows),
        kernel_record("egnn_layer_fwd", "egnn_layer_fwd.cu",
                      "immunostruct_tpu/ops/experimental/pallas_egnn.py:48",
                      B7_INDEX, b7_counts[B7_INDEX], b7, b7_rows),
    ]}
    assert len(record["kernels"]) == 11
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
