#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one CUDA card.

Phases, each printed as it runs; any failure raises and exits non-zero:

1. ``device``: the card, torch, ``nvidia-smi``'s name and power limit, and
   the build of the CUDA kernels from ``src/repro_torch/csrc``;
2. ``kernels``: every kernel of the paths below against its plain PyTorch
   version on the card, at the reference's sweep shapes and at the paths'
   shapes, with the kernel's, the plain version's and one library call's
   times beside the least time the card could take (flash at both paths'
   head dims, 64 and 256, as two records; pack and unpack in turns with
   ``torch.cat`` / ``split_with_sizes_copy``, sparsify with
   ``torch.gather``), the RG-LRU scan forward and its fused backward, the
   MoE position kernel at the MoE cells' shapes, and pack / unpack on
   1,200 pieces under ``torch.cuda.set_sync_debug_mode("error")``;
3. ``main``: 3 ZeRO steps of full-width granite-3-2b under the DynaComm
   plan, with the kernels' launches in those steps asserted against the
   plan;
4. ``ps``: 3 synchronous-PS steps of full-width granite-3-2b with int8
   pushes, then 3 with top-k (fraction 0.01) pushes, under the consensus
   plan of ``ps.json``'s topology, with every kernel's launches asserted
   against the plan and the push compression ratio against its formula;
   each path again from the same seed with the round trip composed from
   the plain versions, whose losses must equal the kernel path's bitwise;
5. ``dynamic``: the run-time loop at the main path's full width.  First
   pack / unpack bitwise at the bucket shapes the re-plan brings; then the
   ``dynamic`` runtime under ``dynamic.json``'s 10 → 1 Gbps shift (a
   re-plan every 2 steps, 4 steps: the plan swaps from 5 / 2 to 10 / 3
   buckets at step 2), plans, events, collective counts and launches
   asserted against the port's own ``core``, losses bitwise phase
   ``main``'s, and the same with async planning; the measured-cost run
   (fc / bc by CUDA events, one call a layer, at epochs 0 and 1) beside a
   traced step; and
   ``dynamic-ps`` on ``dynamic_ps.json``'s topology, plain (the push plan
   re-segments) and with int8 pushes (it does not);
6. ``hybrid``: 4 ZeRO steps of full-width recurrentgemma-2b (18 RG-LRU
   blocks through the ``rglru_scan`` kernel and its fused backward
   ``rglru_scan_bwd``, 8 local-attention blocks
   through flash attention at head dim 256), launches asserted against the
   plan and the layer kinds; then 2 steps with the scan replaced by
   its plain loop (autograd through it), whose losses must equal bitwise;
7. ``async``: the bounded-staleness asynchronous PS.  The paper's small
   CNN (3 workers, SGD 0.05, 12 accepted pushes at k = 1) under ``reject``
   and ``wait``, its events exactly and its losses to a tolerance against
   the port on the CPU, and the paper's Fig. 10 claim (sequential against
   DynaComm plan, losses bitwise); then full-width granite-3-2b under
   ``ps_async.json``'s schedule (2 workers, 2 servers, 10 / 1 Gbps, k = 1,
   ``wait``, AdamW): ``ps-async`` plain at 40 layers (events, losses,
   ledger against the segment formula, seconds a push, peak memory, flash
   launches per gradient computation; its first 4 pushes again with the
   plain attention, the same events and the losses to a tolerance),
   ``dynamic-ps-async``
   under ``dynamic_ps_async.json``'s schedule (re-plans against the
   port's own ``core``; the same commit order and losses as
   ``ps-async``) and ``ps-async`` with int8 pushes at 20 layers (launches
   per layer and push, the push ratio against its formula, the plain
   round trip's losses bitwise);
8. ``fleet``: the elastic fleet (``fleet-async``) at granite-3-2b's full
   width under ``fleet_async.json``'s topology (3 workers, 2 servers, 10 /
   1 Gbps, k = 1, ``wait``, AdamW, 2 workers a shard) with its schedule
   scaled to one worker iteration T: a join at 1.5 T, a crash of a worker
   in flight at 2.5 T and a leave at 3.5 T that re-shards from 2 servers
   to 1; 6 accepted pushes.  The membership, re-plan and commit streams,
   push histories and plans equal the port's ``FleetTrainer`` on the CPU
   over toy layers with the full-width profiles; flash launches, the
   ledger against the segment formula (the crash's partial walk
   included), the migrated bytes against the shard formula, pulls pinned
   at the retained snapshot bitwise across the reshard, seconds a push
   and peak memory against the reckoning; then a resume witness at 4
   layers of full width (``save_state`` mid-run, a fresh runtime restored
   from it gives the rest of the run bitwise);
9. ``pipeline``: the pipeline runtime at granite-3-2b's full width under
   ``pipeline.json``'s block (S = 2 stages, M = 2 micro-batches, 1f1b),
   3 steps: flash against its plain version at the path's shape (one
   sequence a micro-batch), the partition, the ledger against its
   formula, flash launches (3 a block and micro-batch) and no other
   kernel, no collective and no process group, peak memory against the
   reckoning, the losses against the main path's (rtol 1e-5: the
   micro-batches regroup the sums), seconds a step, and the transfer plan
   and simulated timeline printed; then a witness at 4 blocks
   of full width: losses and parameters bitwise across S at M = 1,
   between S = 2 and 4 at M = 2, between gpipe and 1f1b, and with
   ``stage_devices`` on the card against ``None``;
10. ``moe``: the MoE MLP at granite-moe-1b-a400m's full width (24
   layers, d_model 1024, 16/8 heads of 64, 32 experts of d_ff 512, top-8,
   gated SiLU, tied head): flash against its plain version at GQA 16/8
   (B = 2, timed as the record ``flash_attention_fwd@moe``, and the
   pipeline's B = 1); bucket_pack / bucket_unpack bitwise against their
   plain versions at the plan's pull and push buckets; 3 ``zero`` steps
   under the DynaComm plan (asserted against the port's own ``core``),
   launches, seconds a step, peak memory
   against the reckoning, and the same steps under the other three
   strategies, losses bitwise; the aux witness at 2 blocks (the ZeRO
   step's gradients against autograd of ``train_loss``, each leaf within
   4e-6 of its own largest magnitude, and the router's gradient moved at
   ``aux_weight = 0``); ``pipeline`` (S = 2, M = 2,
   1f1b, 3 steps: partition, ledger, flash and MoE position launches and
   no other kernel, no collective, peak, losses against S = 1, M = 2 to
   rtol 1e-5; gpipe against 1f1b bitwise at 4 blocks); then a reduced MoE
   that drops tokens under ``zero.json`` and ``pipeline.json`` on the card
   against the port on the CPU;
   ``mla``: 3 ``zero`` steps of Moonlight-16B-A3B cut to 3 layers of
   d_model 1024 (the dense layer 0, two MoE layers of 4 experts), its
   latent attention at the published widths (16 heads, q / k 192, v 128,
   a latent of 512) under the DynaComm plan: launches against the plan,
   every flash launch the 192 / 128 template's (the launches of the
   record ``flash_attention_fwd@mla``);
11. ``families``: the last model families at their published widths.
   xlstm-350m (24 layers: 21 mLSTM, 3 sLSTM; d_model 1024, 4 heads, the
   mLSTM's head dim 512, vocab 50304, tied head): the mLSTM's parallel
   form against its chunkwise form on the card at (2, 4, 256, 512);
   bucket_pack / bucket_unpack bitwise at its plan's buckets; 3 ``zero``
   steps under the DynaComm plan (asserted against the port's own
   ``core`` and the reference's plan), the copies' launches against the
   plan and no flash launch, seconds a step, peak against the reckoning,
   the other three strategies (losses and parameters bitwise);
   ``pipeline`` (S = 2, M = 2, 1f1b, 3 steps: partition, ledger, no
   kernel of csrc/, no collective, peak; the first two losses against S =
   1, M = 2; S = 1 against S = 2 at M = 1 bitwise at 8 layers); the
   8-layer witness (one sLSTM block, T = 1024) with SGD, card against
   CPU; then flash at hubert-xlarge's (2, 16, 1024,
   80), non-causal (the HD = 128 template), timed as the record
   ``flash_attention_fwd@hubert``, and hubert-xlarge (48 layers, d_model
   1280, d_ff 5120 GELU, untied head, stub frames from ``batch_for``)
   under ``zero``: flash 288 and the copies against the plan, seconds a
   step, peak, the four strategies bitwise (its stub labels are all 0:
   the loss reaches 0.0 after a step, so the parameters are held too);
12. ``serve``: serving at full width through ``repro_torch.launch.serve``
   (greedy, ``torch.inference_mode()``): granite-3-2b (4 requests x 1024
   prompt tokens -> 64 new), recurrentgemma-2b (2 x 2100 -> 32: past its
   2048-token window, so the prefill rolls the local caches and the decode
   rotates them), xlstm-350m (2 x 1024 -> 32) and granite-moe-1b-a400m (4
   x 1024 -> 32).  Flash against its plain version at each prefill shape
   (timed at granite-3-2b's: the record ``flash_attention_fwd@serve``) and
   the scan bitwise at recurrentgemma-2b's (the record
   ``rglru_scan@serve``); per model the kernels' launches in the prefill
   (flash a attention block, the scan an RG-LRU block) and none in the
   decode, the caches' bytes against the reckoning, prefill ms, decode ms
   a token, tokens/s and peak; one full forward over prompt + served
   tokens against every decoded position's logits and greedy token; the
   xLSTM prefill's sLSTM share; then reduced recurrentgemma-2b (window 64,
   P = 70, T = 100) and granite-3-2b served on the card against the CPU;
13. ``verify``: the verification layer (``repro_torch.analysis``) on the
   card, one NCCL rank: ``verify_runtime`` on full-width granite-3-2b under
   ``zero`` (its recorded step's 5 all-gathers and 2 reduce-scatters
   against the FlatSpec byte math, its launches against the plan), ``ps``
   with int8 and with top-k pushes (wire model and ledger exact),
   ``dynamic`` (two plans, each plan's first step traced once) and
   ``pipeline`` (every stage's forward and backward trace empty; ledger,
   partition and transfer plans), then the ten smoke configs; each gives
   no finding.  Then one mutation: zero's recorded step against its plan
   with one pull bucket split must be flagged (``SCHED-AG-COUNT``,
   ``SCHED-AG-BYTES``);
14. ``configs``: the checked-in ``zero.json`` / ``local.json`` /
   ``ps.json`` / ``dynamic.json`` / ``dynamic_ps.json`` /
   ``ps_async.json`` / ``ps_async_int8.json`` / ``dynamic_ps_async.json`` /
   ``fleet_async.json`` / ``pipeline.json`` smoke configs through the
   launcher (``ps.json`` plain, int8 and top-k);
   zero against local to fp32 tolerance, zero bitwise across the four
   scheduling strategies, and plain ps bitwise equal to zero; then
   ``ps.json`` plain, int8 and top-k, ``dynamic.json``, ``dynamic_ps.json``,
   the three async configs, ``pipeline.json``, ``fleet_async.json`` plain
   and int8 (its
   events and push histories equal, the int8 launches a layer of each
   accepted push and partial walk) and a reduced recurrentgemma-2b
   ``zero`` run, on the card against the port on the CPU from one initial
   state, to a stated tolerance;
15. ``loop``: the training loop and the stacked-layer model at full width.
   ``TrainLoop`` on granite-3-2b (AdamW, no remat, 3 steps of 2 x 1024):
   losses bitwise ``build_train_step`` driven by hand, flash 40 a step and
   no other kernel, seconds a step, tokens/s and peak against the
   reckoning; ``accum_steps=2`` to ``ACCUM_RTOL``; the checkpoint round
   trip at 2 layers of full width, bitwise.  Then the stacked granite-3-2b
   step (``train_loss_scanned`` and its gradients) bitwise the unrolled
   step with per-block remat, at remat off, per group and two-level
   (``remat_sqrt=8``), flash 40 / 80 / 115, each peak against its
   reckoning; and the stacked recurrentgemma-2b forward (8 groups of 3 + 2
   remainder layers) bitwise ``forward``'s, flash (hd 256) and the scan
   once a block;
16. ``structure``: the dry runs on fake tensors, each a process of its own
   with no card visible, all at once: ``launch.zero_dryrun`` on
   granite-3-2b at 256 fake ranks (each strategy's recorded all-gathers /
   reduce-scatters equal its plan's F / B, the operand bytes the FlatSpec
   math, ``fm_*`` the ``--skip-lowering`` run's) and ``launch.dryrun`` of
   grok-1-314b and llava-next-34b x train_4k on 16 x 16 (``[ok]``, the
   per-device state bytes the sharding rules' reckoning);
17. ``examples``: the nine ``examples/torch_<name>.py`` scripts in this
   process (``runpy``, no ``--device``: on the card).  Flash against its
   plain version at their shapes (hd 128 at 4 heads; reduced gemma2-2b's
   hd 64, window 64, softcap 50); each at the reference's defaults, its
   text (masked: clock figures, losses, sampled ids) equal to the
   reference's (``tests/fixtures/examples``) and its launches equal to its
   runtimes' plans (flash an attention block in a served prefill, none in
   decode, none outside), every loss finite; each at its tests' small
   flags on the card, drawing on the host, and with ``--device cpu``: the
   masked texts equal, the losses and served logits the CPU's
   (``tests/helpers/torch_examples.py`` runs and masks them); full-width
   recurrentgemma-2b cut to 9 layers, 5 steps on the card from the port's
   seed-3 host draw against the CPU's losses from that draw (a rise at
   step 5, as the reference's from the same draw); then gemma2-2b, the
   serving example's model, at full width: flash against its plain
   version at its prefill (2, 8/4, 4200, 256), causal, softcap 50, at
   window 4096 and 0, timed beside the plain version and ``flex_attention``
   compiled with a softcap score_mod (the record
   ``flash_attention_fwd@gemma2``), and 2 x 4200 -> 32 served greedily
   through the launcher past its 4096-token window (flash 26 in the
   prefill, none in decode, the KV caches 1,773,797,376 B, decode logits
   within 5e-4 of one full forward).

The line ``[time] phase wall seconds {...}`` gives each phase's seconds
(``verify`` included) and the script's total.  The last lines are
``nvidia-smi``'s line, the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
before printing any result.

    python3 chip_smoke.py                   # everything, as a check
    python3 chip_smoke.py --profile         # also trace one step per path,
                                            # its launches against the counters
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # fp32 outside the tensor cores
              torch.bfloat16: 989e12}     # dense bf16 tensor cores
F32_ATOL, BF16_ATOL = 2e-6, 2e-2          # tests/test_kernels.py tolerances
LOSS_RTOL = 1e-5                          # zero vs local: another sum order
CARD_CPU_RTOL = 2e-6     # ps.json card vs CPU, 5x the largest gap measured
STEPS = 3

MAIN = dict(runtime="zero", arch="granite-3-2b", reduced=False, batch=2,
            seq=1024, optimizer="adamw")
PS = dict(MAIN, runtime="ps")              # + ps.json's topology (default)
HYBRID = dict(MAIN, arch="recurrentgemma-2b")
HYBRID_STEPS = 4          # past the loss's rise at step 3 (ROADMAP queue 3)
HYBRID_WITNESS_STEPS = 2  # the plain-scan witness: one step past an update
DYNAMIC_STEPS = 4         # a re-plan every 2 steps: the swap at step 2
# the plans the 10 -> 1 Gbps shift gives at full width (pull, push bucket
# sizes), computed host-only with the reference's core
DYNAMIC_PLANS = (((2, 8, 29, 1, 2), (40, 2)),
                 ((2, 8, 3, 2, 3, 6, 2, 1, 14, 1), (38, 2, 2)))
DYNAMIC_PS_PUSH = ((40, 2), (38, 2, 2))   # dynamic_ps.json, plain pushes
MEMORY_SLACK = 1 << 30    # a dynamic run's peak over the main path's
HYBRID_SMOKE_SEQ = 80           # past the reduced window of 64
HYBRID_CARD_CPU_RTOL = 2e-6    # ps.json's bound; 7.8e-8 measured on an H100
CNN_PUSHES = 12           # the reference's async CNN tests
FIG10_PUSHES = 8
ASYNC_PUSHES = 6          # full-width async runs, accepted pushes each
ASYNC_WITNESS_PUSHES = 4  # the plain-attention witness: its first pushes
ASYNC_INT8_PUSHES = 4
ASYNC_INT8_LAYERS = 20    # int8 adds a residual per worker: 40 do not fit
ASYNC_CONFIGS = ("ps_async", "ps_async_int8", "dynamic_ps_async")
FLEET_PUSHES = 6          # accepted pushes of the full-width fleet run
# the fleet's schedule in units of one worker iteration T: a join after the
# first commits, a crash (a fail's default mode) while its worker is in
# flight, a leave that takes the fleet to 2 workers and the shards 2 -> 1
FLEET_EVENTS = ((1.5, "join", 3), (2.5, "fail", 1), (3.5, "leave", 2))
FLEET_RESUME_LAYERS = 4   # 40 would write ~28 GB of server state to disk
FLEET_RESUME_PUSHES = 3   # pushes before and after the checkpoint
ACTIVATION_GIB = 1.2      # remat's activations, measured in phase async
PIPELINE_SEGMENTS = ((1, 22), (23, 42))   # S = 2 at 1e10 FLOP/s
# beyond parameters, mu, nu and gradient accumulators: a micro-batch's
# activations, the head's logits, one layer's gradients, the embedding's
# gradient from the head and AdamW's temporaries, reckoned before the run
PIPELINE_ACTIVATION_GIB = 2.0
PIPELINE_WITNESS_LAYERS = 4   # the bitwise witness's one cut: depth
MOE = dict(MAIN, arch="granite-moe-1b-a400m")
# Moonlight-16B-A3B's latent attention at its published widths on a cut
# model: the dense layer 0 and two MoE layers of 4 experts
MLA = dict(MAIN, arch="moonlight-16b-a3b")
MLA_LAYERS, MLA_D_MODEL, MLA_VOCAB = 3, 1024, 8192
MOE_STRATEGIES = ("sequential", "lbl", "ibatch")   # beside main's dynacomm
MOE_PIPELINE_SEGMENTS = ((1, 14), (15, 26))   # S = 2 at 1e10 FLOP/s
# the ZeRO step holds ~6 copies of the parameters at its peak (main: 55.89
# GiB for 2.53 B parameters); beyond them, activations, the head's logits
# and the dispatch buffers, reckoned before the run
MOE_COPIES = 6
MOE_ACTIVATION_GIB = 2.0
MOE_AUX_LAYERS = 2        # the aux witness's one cut: depth
MOE_WITNESS_LAYERS = 4    # the gpipe / 1f1b witness's one cut: depth
# reduced granite-moe for card against CPU: 8 experts at top-2 and
# capacity factor 0.5, so tokens drop (reduced() alone drops none)
MOE_DROPPING = dict(num_experts=8, top_k=2, capacity_factor=0.5)
GRAD_SCALE_RTOL = 4e-6    # a gradient leaf against its largest magnitude
XLSTM = dict(MAIN, arch="xlstm-350m")
HUBERT = dict(MAIN, arch="hubert-xlarge")
# the DynaComm plans at full width (pull, push bucket sizes), computed
# host-only with the reference's core
FAMILY_PLANS = {"xlstm-350m": ((2, 3, 9, 1, 1, 10), (24, 2)),
                "hubert-xlarge": ((2, 4, 44), (48, 2))}
FAMILY_STRATEGIES = ("sequential", "lbl", "ibatch")  # beside dynacomm
XLSTM_PIPELINE_SEGMENTS = ((1, 14), (15, 26))   # S = 2 at 1e10 FLOP/s
# the ZeRO step's ~6 copies of the parameters (MOE_COPIES); beyond them the
# head's logits (xlstm: 0.4 GB at vocab 50304), one block's recompute under
# autograd (the sLSTM loop's 1024 steps of saved (2, 1024) tensors, the
# mLSTM's chunk carries of 8 MiB) and each block's saved input, reckoned
# before the run
FAMILY_COPIES = 6
FAMILY_ACTIVATION_GIB = 2.0
MLSTM_FORMS_SHAPE = (2, 4, 256, 512)   # the full-width block's (B, H, T, hd)
MLSTM_FORMS_ATOL = 5e-4   # tests/test_models.py::test_mlstm_chunkwise_...
XLSTM_WITNESS_LAYERS = 8  # the witnesses' one cut: depth (one sLSTM block)
WITNESS_LR = 1e-2         # SGD, as tests/test_torch_xlstm.py's trainers
# card against CPU after an SGD step, each parameter leaf against its
# largest magnitude.  The norm scales start at zero, so after the step they
# are lr times the gradient and carry the gradient's own gap: the
# 8-layer model bound of tests/test_torch_xlstm.py, where each float32
# gradient leaf lies within 6.5e-4 of float64 (its float64 witness) and two
# float32 runs within twice that
XLSTM_WITNESS_RTOL = 2e-3
# serving at full width: arch -> (requests, prompt, new tokens), greedy,
# through repro_torch.launch.serve.  recurrentgemma's prompt passes its
# 2048-token window, so the prefill rolls the local caches and the decode
# rotates them
SERVE = {"granite-3-2b": (4, 1024, 64),
         "recurrentgemma-2b": (2, 2100, 32),
         "xlstm-350m": (2, 1024, 32),
         "granite-moe-1b-a400m": (4, 1024, 32)}
# decode logits against one full forward over prompt + served tokens: the
# reference's bound for the claim (tests/test_models.py::
# test_prefill_decode_matches_full_forward, 5e-4 absolute); xLSTM's against
# the logits' largest magnitude, the CPU's xLSTM bound
# (tests/test_torch_serve.py: within 1e-3 of each array's scale, from its
# float64 witness)
SERVE_FULL_ATOL = 5e-4
SERVE_XLSTM_RTOL = 1e-3
# reduced serving, the card against the port on the CPU from one initial
# state: logits atol (the full-forward bound's fifth: the card's prefill
# runs the kernels, the CPU's the plain versions, one step the same ops)
SERVE_CARD_CPU_ATOL = 1e-4
SERVE_CARD_CPU = (("recurrentgemma-2b", 70, 100), ("granite-3-2b", 24, 40))
# gemma2-2b served at full width past its 4096-token window: (requests,
# prompt, new tokens), greedy, through repro_torch.launch.serve
GEMMA2 = ("gemma2-2b", 2, 4200, 32)
GEMMA2_KV_BYTES = 1_773_797_376    # 13 x 4232 + 13 x 4096 slots x 16,384 B
# recurrentgemma-2b at full width cut to its first L layers (the pattern's
# order: 3 is (rglru, rglru, local_attn), 9 three of those), phase hybrid's
# config, from the port's draw of seed s on the host: (L, s) -> the port's
# CPU run from the same draw (its SHA-256 and losses, by
# tests/helpers/hybrid_loss_check.py --full-width --layers L --seed s,
# which also runs the reference from it; the CPU takes ~41 s a step at 3
# layers, too long for this script), held to CARD_CPU_RTOL.  (9, 3) rises
# at step 5, in both packages from this draw, 3.65e-7 apart (ROADMAP queue
# 3).  The hash pins torch's CPU generator (torch 2.11 and 2.13 draw the
# same state): a torch that draws another fails the hash check, and the
# losses are then taken again.  Each host draw takes
# ~30 s, so one is run here
HYBRID_DRAWS = {
    (9, 3): ("d2681934658fc901c2e3cdfc4fb557b0000e9b2372dd35e5eaaf2b81da988852",
             (23.029619216918945, 12.874444961547852, 9.195002555847168,
              7.839303016662598, 8.445832252502441))}
SMOKE_CONFIGS = ("zero", "local", "ps", "dynamic", "dynamic_ps", "ps_async",
                 "ps_async_int8", "dynamic_ps_async", "fleet_async",
                 "pipeline")
TOPK_FRACTION = 0.01
LOOP_LR = 3e-4            # the runtimes' default AdamW rate
ACCUM_RTOL = 1e-5         # accum_steps=2 regroups the mean; 1e-7 measured
LOOP_CKPT_LAYERS = 2      # the round trip's one cut: 40 layers write ~30 GB
SCANNED_REMAT_SQRT = 8    # granite-3-2b's 40 groups: 5 chunks of 8
# per-device (params, AdamW state) bytes on 16 x 16 (stacked, bf16
# weights, fp32 moments): the reference rules' reckoning
STRUCTURE_STATE_BYTES = {"grok-1-314b": (2_466_743_040, 9_866_972_164),
                         "llava-next-34b": (265_181_056, 1_060_724_228)}
STRUCTURE_TIMEOUT_S = 600
PS_SCHEMES = (("int8", ("compress_quantize", "compress_dequantize")),
              ("topk", ("compress_sparsify", "compress_densify")))
PACK_SWEEP = ((512,), (512, 1024), (2048, 512, 512, 1024), (512,) * 7,
              (100, 700, 513))
# (b, h, hkv, t, hd, causal, window, softcap): the reference's sweep
# (tests/test_kernels.py::TestFlashAttention), then ragged tails
FLASH_SWEEP = ((2, 4, 2, 256, 64, True, 0, 0.0),
               (1, 2, 2, 256, 128, True, 128, 0.0),
               (2, 2, 1, 384, 64, True, 0, 50.0),
               (1, 4, 4, 256, 80, False, 0, 0.0),
               (1, 2, 2, 512, 64, True, 100, 30.0),
               (2, 4, 4, 16, 64, True, 0, 0.0),          # smoke configs' T
               (1, 4, 2, 200, 64, True, 64, 0.0),
               (1, 2, 1, 77, 80, False, 0, 0.0),
               # head dim 256 (recurrentgemma-2b): GQA 10/1, the window bites
               (1, 10, 1, 4096, 256, True, 2048, 0.0),
               (2, 4, 1, 256, 256, True, 0, 0.0),
               (1, 2, 2, 200, 256, True, 64, 30.0),
               # the tiles' edges: T past a 128- / 64-row tile, hd 96 and
               # 112 inside their 128 template, a window edge inside a tile
               (1, 2, 1, 130, 64, True, 0, 0.0),
               (1, 2, 2, 70, 96, True, 0, 0.0),
               (1, 2, 1, 200, 112, True, 0, 20.0),
               (1, 2, 2, 300, 80, True, 37, 0.0),
               (1, 4, 2, 129, 256, True, 40, 0.0))
# (b, t, w): ragged widths and lengths, then the hybrid path's shape
RGLRU_SWEEP = ((1, 200, 100), (3, 17, 33), (1, 1, 5), (70000, 3, 5),
               (2, 1024, 2560))
REPLACES = {
    "bucket_pack": "src/repro/kernels/bucket_pack/bucket_pack.py:76",
    "bucket_unpack": "src/repro/kernels/bucket_pack/bucket_pack.py:124",
    "flash_attention_fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:111",
    "flash_attention_fwd@hd256":
        "src/repro/kernels/flash_attention/flash_attention.py:111",
    "flash_attention_fwd@moe":
        "src/repro/kernels/flash_attention/flash_attention.py:111",
    "flash_attention_fwd@hubert":
        "src/repro/kernels/flash_attention/flash_attention.py:111",
    "compress_quantize": "src/repro/kernels/compress/compress.py:81",
    "compress_dequantize": "src/repro/kernels/compress/compress.py:137",
    "compress_sparsify": "src/repro/kernels/compress/compress.py:178",
    "compress_densify": "src/repro/kernels/compress/compress.py:210",
    "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:60",
    "rglru_scan_bwd": "src/repro/kernels/rglru_scan/rglru_scan.py:60",
    "flash_attention_fwd@serve":
        "src/repro/kernels/flash_attention/flash_attention.py:111",
    "rglru_scan@serve": "src/repro/kernels/rglru_scan/rglru_scan.py:60",
    "flash_attention_fwd@gemma2":
        "src/repro/kernels/flash_attention/flash_attention.py:111",
    "flash_attention_fwd@mla":
        "src/repro/kernels/flash_attention/flash_attention.py:111",
}
SOURCES = {"bucket_pack": "src/repro_torch/csrc/bucket_pack.cu",
           "bucket_unpack": "src/repro_torch/csrc/bucket_pack.cu",
           "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
           "flash_attention_fwd@hd256":
               "src/repro_torch/csrc/flash_attention.cu",
           "flash_attention_fwd@moe":
               "src/repro_torch/csrc/flash_attention.cu",
           "flash_attention_fwd@hubert":
               "src/repro_torch/csrc/flash_attention.cu",
           "compress_quantize": "src/repro_torch/csrc/compress.cu",
           "compress_dequantize": "src/repro_torch/csrc/compress.cu",
           "compress_sparsify": "src/repro_torch/csrc/compress.cu",
           "compress_densify": "src/repro_torch/csrc/compress.cu",
           "rglru_scan": "src/repro_torch/csrc/rglru_scan.cu",
           "rglru_scan_bwd": "src/repro_torch/csrc/rglru_scan.cu",
           "flash_attention_fwd@serve":
               "src/repro_torch/csrc/flash_attention.cu",
           "rglru_scan@serve": "src/repro_torch/csrc/rglru_scan.cu",
           "flash_attention_fwd@gemma2":
               "src/repro_torch/csrc/flash_attention.cu",
           "flash_attention_fwd@mla":
               "src/repro_torch/csrc/flash_attention.cu"}
PORT_KERNELS = ("copy_chunks_kernel", "flash_fwd_kernel",    # csrc/*.cu
                "quantize_pack_kernel", "dequantize_unpack_kernel",
                "sparsify_kernel", "densify_kernel", "rglru_scan_kernel")
TRACE_SYMBOLS = {           # a kernel's name in a trace -> its counters
    "copy_chunks_kernel": ("bucket_pack", "bucket_unpack"),
    "flash_fwd_kernel": ("flash_attention_fwd",),
    "quantize_pack_kernel": ("compress_quantize",),
    "dequantize_unpack_kernel": ("compress_dequantize",),
    "sparsify_kernel": ("compress_sparsify",),
    "densify_kernel": ("compress_densify",),
    "rglru_scan_kernel": ("rglru_scan", "rglru_scan_bwd")}
SECTOR_BYTES = 32        # the least a random 4-byte gather moves from DRAM
L2_FLUSH_BYTES = 128 << 20               # > the H100's 50 MB of L2
HOST_AHEAD_CYCLES = 20_000_000           # ~10 ms of SM clock at 1.98 GHz


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def host_ahead() -> None:
    """Queue a device-side wait (about 10 ms at the H100's clock) so the
    host enqueues the calls timed after it before the first one runs: the
    events then read the device's time back to back, not the host's
    per-call overhead (Python, ctypes), which exceeds a 0.03 ms kernel on a
    slow host."""
    torch.cuda._sleep(HOST_AHEAD_CYCLES)


def cuda_ms(fn, iters: int, warmup: int = 2, ahead: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events;
    ``ahead=False`` for a loop the host paces (tens of ms of launches),
    whose time the wait would partly hide."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        host_ahead()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def warm_up(fn, seconds: float = 0.2) -> None:
    """Launch ``fn`` back to back for ``seconds`` of host time: a card left
    idle by host-bound work (the plain loops) times short kernels slow
    until its clocks come back up."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()


def cuda_ms_cold(fn, iters: int) -> float:
    """Mean device time of ``fn`` with a cold L2: a buffer larger than the
    L2 is overwritten before each call, outside its events."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    host_ahead()
    for start, end in events:
        flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def free_cuda() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({4: torch.int32, 2: torch.int16,
                   1: torch.int8}[x.element_size()])


def assert_bitwise(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or \
            not torch.equal(bits(a), bits(b)):
        raise AssertionError(f"{what}: kernel and plain version differ")


def leaf_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` over ``want``'s own largest magnitude:
    a gradient leaf is a sum over tokens, so its roundoff scales with the
    leaf, not with each entry (a router entry of 26 beside one of 0.16).
    The floor is fp32's smallest normal: an all-zero leaf must come out
    zero."""
    scale = max(want.abs().max().item(), torch.finfo(torch.float32).tiny)
    return (got.to(want.device) - want).abs().max().item() / scale


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)}, "
                  f"{torch.cuda.device_count()} card(s); torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}")
    say("device", f"nvidia-smi: {smi}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library("bucket_pack")
    info = _build.BUILD_INFO
    say("device", f"built {', '.join(info['built']) or 'nothing (cached)'} "
                  f"in {time.perf_counter() - t0:.1f} s into "
                  f"{info['directory']}")
    for name, log in info["logs"].items():
        for kernel, regs, spills in ptxas_usage(log):
            say("device", f"ptxas {name}: {kernel}: {regs} registers, "
                          f"{spills}")
    return smi


def ptxas_usage(log: str) -> list:
    """(kernel, registers, spill stores and loads) for each entry function
    in ``nvcc -Xptxas=-v`` output."""
    out, kernel, spills = [], "?", "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = re.search(r"\d([a-z_]+_kernel)", mangled)
            args = (["bf16"] if "bfloat16" in mangled else
                    ["f32"] if re.search(r"_kernelIf", mangled) else [])
            args += re.findall(r"Li(\d+)E", mangled)
            kernel = (base.group(1) if base else mangled) + (
                f"<{', '.join(args)}>" if args else "")
        elif "spill stores" in line:
            spills = line.split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line:
            out.append((kernel, int(re.search(r"Used (\d+) registers",
                                              line).group(1)), spills))
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def main_plan_specs(name: str = MAIN["arch"]):
    """A path's plan and flat layouts at MAIN's batch and sequence (the
    main path's model by default), priced without allocating."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import (DynaCommScheduler, costs_from_profiles,
                                  plan_from_decision)
    from repro_torch.dist.collectives import make_flat_spec
    from repro_torch.models import (num_sched_layers, param_shapes,
                                    sched_layer_trees)
    from repro_torch.models.profiles import layer_profiles
    from repro_torch.runtime import MeasureConfig, NetworkConfig
    arch = get_config(name)
    costs = costs_from_profiles(
        layer_profiles(arch, InputShape("runtime", MAIN["seq"], MAIN["batch"],
                                        "train")),
        net=NetworkConfig().build(),
        compute_flops_per_s=MeasureConfig().compute_flops_per_s)
    decision = DynaCommScheduler(strategy="dynacomm").decision_for_iteration(
        costs)
    plan = plan_from_decision(*decision, num_sched_layers(arch))
    specs = [make_flat_spec(t, 1)
             for t in sched_layer_trees(param_shapes(arch))]
    return arch, plan, specs


def check_bucket_kernels(gen, dev) -> None:
    from repro_torch.kernels.bucket_pack import ops, ref
    for dtype in (torch.float32, torch.bfloat16):
        for lengths in PACK_SWEEP:
            vecs = [torch.randn(n, generator=gen, device=dev).to(dtype)
                    for n in lengths]
            segs, alens = ops.pad_segments(vecs)
            flat = ops.bucket_pack(segs, alens)
            assert_bitwise(flat, ref.bucket_pack_ref(segs, alens),
                           f"bucket_pack {lengths} {dtype}")
            assert_bitwise(ops.bucket_unpack(flat, alens, segs.shape[1]),
                           ref.bucket_unpack_ref(flat, alens, segs.shape[1]),
                           f"bucket_unpack {lengths} {dtype}")
        # the collective form: views at odd offsets, zero runs, many rows
        base = torch.randn(10007, generator=gen, device=dev).to(dtype)
        segments = [base[3:1030], 5, base[1:2], base[100:4197], 17,
                    base[9000:10007]]
        assert_bitwise(ops.pack_ragged(segments),
                       ref.pack_ragged_ref(segments, dtype=dtype, device=dev),
                       f"pack_ragged {dtype}")
        widths = (7, 1030, 1, 513)
        for rows in (1, 2, 3):
            flat = torch.randn(rows * sum(widths), generator=gen,
                               device=dev).to(dtype)
            for w, a, b in zip(widths, ops.unpack_columns(flat, widths, rows),
                               ref.unpack_columns_ref(flat, widths, rows)):
                assert_bitwise(a, b, f"unpack_columns rows={rows} w={w}")
    say("kernels", f"bucket_pack / bucket_unpack bitwise on "
                   f"{len(PACK_SWEEP)} aligned sweeps and the ragged "
                   f"collective form (rows 1-3), f32 and bf16")
    check_no_stream_sync(gen, dev)


def check_no_stream_sync(gen, dev) -> None:
    """pack_ragged / unpack_columns on 1,200 pieces and 1,100 columns of
    all three alignment classes (16-byte, 4-byte, 2-byte offsets; zero
    runs), with the sync debug mode raising on any synchronisation, then
    bitwise against their plain versions."""
    from repro_torch.kernels.bucket_pack import ops, ref
    lo = torch.randint(0, 40000, (1200,), generator=gen, device=dev).tolist()
    n = torch.randint(1, 300, (1200,), generator=gen, device=dev).tolist()
    widths = torch.randint(1, 90, (1100,), generator=gen, device=dev).tolist()
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.randn(50021, generator=gen, device=dev).to(dtype)
        pieces = [n[i] if i % 7 == 0 else base[lo[i]:lo[i] + n[i]]
                  for i in range(1200)]
        flat = torch.randn(3 * sum(widths), generator=gen,
                           device=dev).to(dtype)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            packed = ops.pack_ragged(pieces)
            split = ops.unpack_columns(flat, widths, 3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert_bitwise(packed, ref.pack_ragged_ref(pieces, dtype=dtype,
                                                   device=dev),
                       f"pack_ragged, 1,200 pieces {dtype}")
        for a, b in zip(split, ref.unpack_columns_ref(flat, widths, 3)):
            assert_bitwise(a, b, f"unpack_columns, 1,100 columns {dtype}")
    say("kernels", "pack_ragged (1,200 pieces) and unpack_columns (3 rows x "
                   "1,100 columns), f32 and bf16: no stream synchronisation "
                   "under torch.cuda.set_sync_debug_mode('error'); bitwise")


def in_turns(kernel, library, rounds: int = 4, iters: int = 5) -> tuple:
    """Kernel and library times by CUDA events, in turns (kernel, library,
    library, kernel) over ``rounds`` rounds: two lists of 2 * rounds."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kernel, iters))
        ls.extend(cuda_ms(library, iters) for _ in range(2))
        ks.append(cuda_ms(kernel, iters))
    return ks, ls


def time_bucket_kernels(gen, dev, plan, specs) -> dict:
    """Pack and unpack at the main path's largest pull bucket."""
    from repro_torch.kernels.bucket_pack import ops, ref
    bucket = max(plan.forward, key=lambda b: sum(specs[l].padded for l in b))
    widths = [specs[l].shard_size for l in bucket]
    shards = [torch.randn(w, generator=gen, device=dev) for w in widths]
    nbytes = 4 * sum(widths)
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3   # read once, write once
    iters = 5
    out = {}

    packed = ops.pack_ragged(shards)
    plain = ref.pack_ragged_ref(shards, dtype=torch.float32, device=dev)
    assert_bitwise(packed, plain, "bucket_pack at the main path's bucket")
    del plain
    ks, ls = in_turns(lambda: ops.pack_ragged(shards),
                      lambda: torch.cat(shards))
    out["bucket_pack"] = dict(
        max_abs_err=0.0, ms=sum(ks) / len(ks),
        plain_ms=cuda_ms(lambda: ref.pack_ragged_ref(
            shards, dtype=torch.float32, device=dev), iters),
        library_ms=sum(ls) / len(ls), bound_ms=bound, bound_by="bytes",
        ms_range=[min(ks), max(ks)], library_ms_range=[min(ls), max(ls)])
    del shards

    fulls = ops.unpack_columns(packed, widths, 1)
    for a, b in zip(fulls, ref.unpack_columns_ref(packed, widths, 1)):
        assert_bitwise(a, b, "bucket_unpack at the main path's bucket")
    del fulls
    grid = packed.view(1, -1)
    ks, ls = in_turns(
        lambda: ops.unpack_columns(packed, widths, 1),
        lambda: torch.split_with_sizes_copy(grid, widths, dim=1))
    out["bucket_unpack"] = dict(
        max_abs_err=0.0, ms=sum(ks) / len(ks),
        plain_ms=cuda_ms(lambda: ref.unpack_columns_ref(packed, widths, 1),
                         iters),
        library_ms=sum(ls) / len(ls), bound_ms=bound, bound_by="bytes",
        ms_range=[min(ks), max(ks)], library_ms_range=[min(ls), max(ls)])
    say("kernels", f"main-path bucket: {len(bucket)} layers, "
                   f"{nbytes / 1e9:.3f} GB f32")
    for name, lib in (("bucket_pack", "torch.cat"),
                      ("bucket_unpack", "split_with_sizes_copy")):
        r = out[name]
        say("kernels", f"{name} in turns with {lib} (4 rounds of kernel, "
                       f"library, library, kernel; 5 calls each): "
                       f"{r['ms']:.4f} ms [{r['ms_range'][0]:.4f}-"
                       f"{r['ms_range'][1]:.4f}] against {r['library_ms']:.4f}"
                       f" [{r['library_ms_range'][0]:.4f}-"
                       f"{r['library_ms_range'][1]:.4f}]; "
                       f"{100 * r['bound_ms'] / r['ms']:.1f}% of the byte "
                       f"bound {r['bound_ms']:.4f}")
    return out


def _qkv(gen, dev, b, h, hkv, t, hd, dtype, model_layout):
    """q (b, h, t, hd) and k, v (b, hkv, t, hd); with ``model_layout`` they
    are (b, t, heads, hd) tensors seen through a transpose, as
    ``models/attention.py`` hands them over."""
    def make(heads):
        if model_layout:
            x = torch.randn(b, t, heads, hd, generator=gen, device=dev)
            return x.to(dtype).transpose(1, 2)
        return torch.randn(b, heads, t, hd, generator=gen,
                           device=dev).to(dtype)
    return make(h), make(hkv), make(hkv)


def live_pairs(t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    total = 0
    for q in range(t):
        hi = q if causal else t - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def check_flash(gen, dev, arch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (_ref_fwd,
                                                         flash_attention)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    with torch.no_grad():
        for case in FLASH_SWEEP:
            b, h, hkv, t, hd, causal, window, cap = case
            for dtype in (torch.float32, torch.bfloat16):
                for layout in (False, True):
                    q, k, v = _qkv(gen, dev, b, h, hkv, t, hd, dtype, layout)
                    err = (flash_attention(q, k, v, causal, window, cap)
                           .float() - _ref_fwd(q, k, v, causal, window, cap)
                           .float()).abs().max().item()
                    tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
                    if not err <= tol:
                        raise AssertionError(f"flash {case} {dtype}: max "
                                             f"abs err {err:.3g} > {tol}")
                    worst[dtype] = max(worst[dtype], err)
        say("kernels", f"flash_attention_fwd on {len(FLASH_SWEEP)} sweep "
                       f"cases x 2 layouts: max abs err f32 "
                       f"{worst[torch.float32]:.3g} (atol {F32_ATOL}), bf16 "
                       f"{worst[torch.bfloat16]:.3g} (atol {BF16_ATOL})")

        # the main path's call: (B, T, H, hd) views, GQA 32/8, T = 1024
        rec = time_flash(gen, dev, arch, 0, "main")
        # the hybrid path's: GQA 10/1, hd 256, window 2048 (T = 1024 < it)
        hybrid = get_config(HYBRID["arch"])
        rec256 = time_flash(gen, dev, hybrid, hybrid.sliding_window,
                            "hybrid")
        # latent attention's (the Moonlight cell's call): q / k 192 and v
        # 128, the 192 / 128 template
        rec_mla = time_flash(gen, dev, get_config("moonlight-16b-a3b"), 0,
                             "MLA cell", b=2, t=4096)
    return {"flash_attention_fwd": rec, "flash_attention_fwd@hd256": rec256,
            "flash_attention_fwd@mla": rec_mla}


def time_flash(gen, dev, arch, window: int, path: str,
               causal: bool = True, b: int = MAIN["batch"],
               t: int = MAIN["seq"]) -> dict:
    """Flash forward at a path's shape, f32: checked, then timed beside
    its plain version, SDPA and its bound (the bound counts the
    (query, key) pairs the mask keeps: Q K^T at the path's head dim, P V
    at v's, which latent attention narrows; q, k, v and o moved once)."""
    from repro_torch.kernels.flash_attention.ops import (_ref_fwd,
                                                         flash_attention)
    import torch.nn.functional as F
    h, hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    hdv = arch.v_head_dim or hd
    q, k, v = _qkv(gen, dev, b, h, hkv, t, hd, torch.float32, True)
    if hdv != hd:
        v = torch.randn(b, t, hkv, hdv, generator=gen,
                        device=dev).transpose(1, 2)
    err = (flash_attention(q, k, v, causal, window, 0.0)
           - _ref_fwd(q, k, v, causal, window, 0.0)).abs().max().item()
    if not err <= F32_ATOL:
        raise AssertionError(f"flash at the {path} path's shape: max abs "
                             f"err {err:.3g} > {F32_ATOL}")
    flops = 2 * b * h * (hd + hdv) * live_pairs(t, causal, window)
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + b * h * t * hdv)
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    iters = 20
    rec = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: flash_attention(q, k, v, causal, window, 0.0),
                   iters),
        plain_ms=cuda_ms(lambda: _ref_fwd(q, k, v, causal, window, 0.0),
                         iters),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), iters),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    rec["tflops"] = flops / rec["ms"] / 1e9
    say("kernels", f"flash_attention_fwd at the {path} path's (B={b}, "
               f"H={h}/{hkv}, T={t}, hd={hd}, v {hdv}, "
               f"{'causal' if causal else 'non-causal'}, window {window}) "
               f"f32: max abs err {err:.3g}; {rec['tflops']:.2f} TFLOP/s = "
               f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of its bound; "
               f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, SDPA "
               f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} by "
               f"{rec['bound_by']})")
    return rec


COMPRESS_SWEEP = ((512,), (512, 1024), (2048, 512, 512, 1024), (512,) * 7,
                  (1536, 512, 1024))


def check_compress_kernels(gen, dev) -> None:
    """The four compression kernels bitwise against their plain versions:
    ragged rows with a tiny tile, an all-zero tile, a NaN tile and an inf,
    the error-feedback residual, and top-k rows with -1 slots and chosen
    -0.0 values."""
    from repro_torch.kernels.compress import ops, ref
    for lengths in COMPRESS_SWEEP:
        lmax = max(lengths)
        segs = torch.randn(len(lengths), lmax, generator=gen, device=dev)
        segs *= 10.0 ** torch.randint(-3, 3, (len(lengths), 1), generator=gen,
                                      device=dev)
        segs[0, :512] *= 1e-30
        if len(lengths) > 1:
            segs[1, :512] = 0.0                      # all-zero tile
        if len(lengths) > 2:
            segs[2, 7] = float("nan")                # NaN tile
        if len(lengths) > 3:
            segs[3, 3] = float("inf")
        payload, scales = ops.quantize_pack(segs, lengths)
        want_p, want_s = ref.quantize_pack_ref(segs, lengths)
        assert_bitwise(payload, want_p, f"compress_quantize {lengths}")
        assert_bitwise(scales, want_s, f"compress_quantize scales {lengths}")
        assert_bitwise(ops.dequantize_unpack(payload, scales, lengths, lmax),
                       ref.dequantize_unpack_ref(payload, scales, lengths,
                                                 lmax),
                       f"compress_dequantize {lengths}")
        corrected = segs[0, :lengths[0] - 5].contiguous()
        residual = torch.empty_like(corrected)
        ops.dequantize_unpack(payload, scales, lengths, lmax,
                              feedback=(corrected, residual))
        assert_bitwise(residual, ref.feedback_residual_ref(
            corrected, payload, scales), f"feedback residual {lengths}")
    segs = torch.round(torch.randn(3, 4096, generator=gen, device=dev) * 3)
    segs[2, :100] = -0.0
    segs[2, 10:20] = 1.0
    lengths = (4096, 3000, 100)
    for k in (1, 64, 700):
        idx = ops.topk_indices(segs, lengths, k)
        if not torch.equal(idx.cpu(), ops.topk_indices(segs.cpu(), lengths,
                                                        k)):
            raise AssertionError(f"topk_indices k={k}: card != host")
        vals = ops.sparsify(segs, idx)
        assert_bitwise(vals, ref.sparsify_ref(segs, idx),
                       f"compress_sparsify k={k}")
        assert_bitwise(ops.densify(vals, idx, 4096),
                       ref.densify_ref(vals, idx, 4096),
                       f"compress_densify k={k}")
    neg_zero = (bits(vals) == bits(torch.tensor(-0.0, device=dev))).sum()
    if not ((idx == -1).any() and neg_zero > 0):
        raise AssertionError("the top-k sweep chose no -0.0 or left no -1")
    many = torch.randn(70000, 9, generator=gen, device=dev)   # > grid.y rows
    many_idx = torch.randint(-1, 9, (70000, 3), generator=gen, device=dev,
                             dtype=torch.int32)
    assert_bitwise(ops.sparsify(many, many_idx),
                   ref.sparsify_ref(many, many_idx),
                   "compress_sparsify on 70,000 rows")
    say("kernels", f"compress_quantize / _dequantize (and the feedback "
                   f"residual) bitwise on {len(COMPRESS_SWEEP)} ragged sweeps "
                   f"with zero, tiny, NaN and inf tiles; compress_sparsify / "
                   f"_densify bitwise at k = 1, 64, 700 (sparsify also on "
                   f"70,000 rows) with "
                   f"{int((idx == -1).sum())} -1 slots and {int(neg_zero)} "
                   f"chosen -0.0")


def time_compress_kernels(gen, dev, specs) -> dict:
    """The four kernels at the paths' largest sched layer, the embedding,
    as the compressor calls them (top-k at fraction 0.01)."""
    from repro_torch.kernels.compress import ops, ref
    n = max(s.padded for s in specs)
    npad = ops.aligned(n)
    ntiles = npad // ops.TILE
    seg = torch.randn(1, npad, generator=gen, device=dev) * 1e-3
    iters = 5
    out = {}

    payload, scales = ops.quantize_pack(seg, (npad,))
    want = ref.quantize_pack_ref(seg, (npad,))
    assert_bitwise(payload, want[0], "compress_quantize at the embedding")
    assert_bitwise(scales, want[1], "compress_quantize scales at the "
                                    "embedding")
    del want
    out["compress_quantize"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: ops.quantize_pack(seg, (npad,)), iters),
        plain_ms=cuda_ms(lambda: ref.quantize_pack_ref(seg, (npad,)), iters),
        library_ms=None,
        bound_ms=(4 * npad + npad + 4 * ntiles) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes")

    # the error-feedback form the compressor runs: also writes the residual
    corrected = seg[0, :n]
    residual = torch.empty(n, device=dev)

    def dequantize():
        return ops.dequantize_unpack(payload, scales, (npad,), npad,
                                     feedback=(corrected, residual))

    def dequantize_plain():
        return (ref.dequantize_unpack_ref(payload, scales, (npad,), npad),
                ref.feedback_residual_ref(corrected, payload, scales))

    got = dequantize()
    want = dequantize_plain()
    assert_bitwise(got, want[0], "compress_dequantize at the embedding")
    assert_bitwise(residual, want[1], "feedback residual at the embedding")
    del got, want
    out["compress_dequantize"] = dict(
        max_abs_err=0.0, ms=cuda_ms(dequantize, iters),
        plain_ms=cuda_ms(dequantize_plain, iters), library_ms=None,
        bound_ms=(npad + 4 * ntiles + 4 * npad + 8 * n)
        / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes")
    del payload, scales, residual
    free_cuda()

    row = seg[:, :n]
    k = max(1, math.ceil(TOPK_FRACTION * n))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    idx = ops.topk_indices(row, (n,), k)
    end.record()
    end.synchronize()
    sort_ms = start.elapsed_time(end)
    idx_long = idx.long()
    vals = ops.sparsify(row, idx)
    assert_bitwise(vals, ref.sparsify_ref(row, idx),
                   "compress_sparsify at the embedding")
    slots = int((idx >= 0).sum())
    warm_up(lambda: ops.sparsify(row, idx))
    ks, ls = in_turns(lambda: ops.sparsify(row, idx),
                      lambda: torch.gather(row, 1, idx_long), iters=20)
    out["compress_sparsify"] = dict(
        max_abs_err=0.0, ms=sum(ks) / len(ks),
        plain_ms=cuda_ms(lambda: ref.sparsify_ref(row, idx), 20),
        library_ms=sum(ls) / len(ls),
        bound_ms=(4 * k + 4 * slots + 4 * k) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        ms_range=[min(ks), max(ks)], library_ms_range=[min(ls), max(ls)],
        ms_cold_l2=cuda_ms_cold(lambda: ops.sparsify(row, idx), 20),
        library_ms_cold_l2=cuda_ms_cold(
            lambda: torch.gather(row, 1, idx_long), 20))
    r = out["compress_sparsify"]
    # each gathered value in its own sector: what DRAM must move at least
    floor_ms = (4 * k + SECTOR_BYTES * slots + 4 * k) / HBM_BYTES_PER_S * 1e3
    say("kernels", f"compress_sparsify in turns with torch.gather (4 rounds "
                   f"of kernel, library, library, kernel; 20 calls each): "
                   f"{r['ms']:.4f} ms [{r['ms_range'][0]:.4f}-"
                   f"{r['ms_range'][1]:.4f}] against {r['library_ms']:.4f} "
                   f"[{r['library_ms_range'][0]:.4f}-"
                   f"{r['library_ms_range'][1]:.4f}]; cold L2 "
                   f"{r['ms_cold_l2']:.4f} against "
                   f"{r['library_ms_cold_l2']:.4f}; byte bound "
                   f"{r['bound_ms']:.4f}, sector floor {floor_ms:.4f} "
                   f"({slots} gathered slots)")
    assert_bitwise(ops.densify(vals, idx, n), ref.densify_ref(vals, idx, n),
                   "compress_densify at the embedding")
    out["compress_densify"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: ops.densify(vals, idx, n), iters),
        plain_ms=cuda_ms(lambda: ref.densify_ref(vals, idx, n), iters),
        library_ms=cuda_ms(lambda: torch.zeros(1, n, device=dev).scatter_(
            1, idx_long, vals), iters),
        bound_ms=(8 * k + 4 * n) / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    say("kernels", f"compress kernels at the embedding: {n} f32 = {ntiles} "
                   f"tiles; top-k k = {k} ({TOPK_FRACTION}); topk_indices "
                   f"(stable sort, no kernel) {sort_ms:.3f} ms")
    return out


def _scan_inputs(gen, dev, b, t, w, dtype):
    """a in (0.05, 1) as the path's gates give it, x ~ N(0, 1)."""
    a = torch.rand(b, t, w, generator=gen, device=dev) * 0.95 + 0.05
    x = torch.randn(b, t, w, generator=gen, device=dev)
    return a.to(dtype), x.to(dtype)


def check_rglru(gen, dev) -> dict:
    """``rglru_scan`` bitwise against its plain loop, forward and reverse,
    and its fused backward against the plain composition, f32 and bf16, on
    ragged shapes and the hybrid path's; its autograd gradient bitwise
    against the plain backward; then both timed at the path's shape,
    (B, T, W) = (2, 1024, 2560) f32."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.rglru_scan import ops, ref
    for b, t, w in RGLRU_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            a, x = _scan_inputs(gen, dev, b, t, w, dtype)
            for reverse in (False, True):
                assert_bitwise(ops.scan(a, x, reverse),
                               ref.rglru_scan_ref(a, x, reverse),
                               f"rglru_scan {(b, t, w)} {dtype} reverse="
                               f"{reverse}")
            h = ops.scan(a, x)
            g = torch.randn(a.shape, generator=gen, device=dev).to(dtype)
            before = launch_counts()["rglru_scan_bwd"]
            got = ops.scan_backward(a, h, g)
            if launch_counts()["rglru_scan_bwd"] != before + 1:
                raise AssertionError("scan_backward is not one launch")
            for mine, plain, what in zip(
                    got, ref.rglru_scan_backward_ref(a, h, g), ("da", "dx")):
                assert_bitwise(mine, plain, f"rglru_scan_bwd {what} "
                                            f"{(b, t, w)} {dtype}")
    a, x = _scan_inputs(gen, dev, 2, 200, 100, torch.float32)
    g = torch.randn(a.shape, generator=gen, device=dev)
    ta, tx = a.clone().requires_grad_(), x.clone().requires_grad_()
    h = ops.rglru_scan(ta, tx)
    h.backward(g)
    da, dx = ref.rglru_scan_backward_ref(a, h.detach(), g)
    assert_bitwise(tx.grad, dx, "rglru_scan gradient of x")
    assert_bitwise(ta.grad, da, "rglru_scan gradient of a")
    say("kernels", f"rglru_scan bitwise on {len(RGLRU_SWEEP)} shapes x f32 / "
                   f"bf16 x forward / reverse; rglru_scan_bwd (one launch) "
                   f"bitwise against the plain composition on the same; the "
                   f"autograd gradient bitwise against it")

    b, t, w = RGLRU_SWEEP[-1]
    a, x = _scan_inputs(gen, dev, b, t, w, torch.float32)
    g = torch.randn(a.shape, generator=gen, device=dev)
    h = ops.scan(a, x)
    assert_bitwise(h, ref.rglru_scan_ref(a, x),
                   "rglru_scan at the hybrid path's shape")
    for mine, plain, what in zip(ops.scan_backward(a, h, g),
                                 ref.rglru_scan_backward_ref(a, h, g),
                                 ("da", "dx")):
        assert_bitwise(mine, plain, f"rglru_scan_bwd {what} at the hybrid "
                                    f"path's shape")

    def four_passes():      # the backward it replaces: pad, scan, pad, mul
        dh = ops.scan(torch.nn.functional.pad(a[:, 1:], (0, 0, 0, 1)), g,
                      reverse=True)
        return dh * torch.nn.functional.pad(h[:, :-1], (0, 0, 1, 0)), dh

    nbytes = 4 * a.numel()
    fwd = dict(max_abs_err=0.0,
               plain_ms=cuda_ms(lambda: ref.rglru_scan_ref(a, x), 3,
                                ahead=False),
               library_ms=None, bound_ms=3 * nbytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    bwd = dict(max_abs_err=0.0,
               plain_ms=cuda_ms(
                   lambda: ref.rglru_scan_backward_ref(a, h, g), 3,
                   ahead=False),
               library_ms=None, bound_ms=5 * nbytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    # 8 samples of 20 launches after a warm-up; the backward in turns with
    # the four passes it replaced
    warm_up(lambda: ops.scan(a, x))
    ks = [cuda_ms(lambda: ops.scan(a, x), 20) for _ in range(8)]
    fwd.update(ms=sum(ks) / len(ks), ms_range=[min(ks), max(ks)],
               ms_cold_l2=cuda_ms_cold(lambda: ops.scan(a, x), 20))
    warm_up(lambda: ops.scan_backward(a, h, g))
    ks, ls = in_turns(lambda: ops.scan_backward(a, h, g), four_passes,
                      iters=20)
    bwd.update(ms=sum(ks) / len(ks), ms_range=[min(ks), max(ks)],
               ms_cold_l2=cuda_ms_cold(lambda: ops.scan_backward(a, h, g),
                                       20),
               four_pass_ms=sum(ls) / len(ls),
               four_pass_ms_range=[min(ls), max(ls)])
    for name, r in (("rglru_scan", fwd), ("rglru_scan_bwd", bwd)):
        say("kernels", f"{name} at the hybrid path's (B={b}, T={t}, W={w}) "
                       f"f32: {r['ms']:.4f} ms [{r['ms_range'][0]:.4f}-"
                       f"{r['ms_range'][1]:.4f}] = "
                       f"{100 * r['bound_ms'] / r['ms']:.1f}% of its byte "
                       f"bound {r['bound_ms']:.4f}; cold L2 "
                       f"{r['ms_cold_l2']:.4f}")
    say("kernels", f"rglru_scan_bwd in turns with the four passes it "
                   f"replaces (pad, reverse scan kernel, pad, multiply; 4 "
                   f"rounds, 20 calls each): {bwd['ms']:.4f} ms against "
                   f"{bwd['four_pass_ms']:.4f} "
                   f"[{bwd['four_pass_ms_range'][0]:.4f}-"
                   f"{bwd['four_pass_ms_range'][1]:.4f}]")
    return {"rglru_scan": fwd, "rglru_scan_bwd": bwd}


# the MoE cells' routings: (architecture, tokens a step, experts held)
MOE_POSITION_SHAPES = {
    "moe_positions@moe": ("granite-moe-1b-a400m", 2048, 32),
    "moe_positions@hybrid": ("granite-4.0-h-small", 4096, 8)}


def check_moe_positions(gen, dev) -> dict:
    """The MoE position kernel at the MoE cells' shapes (granite-moe's
    (16,384, E = 32), granite-4.0-h-small's (40,960, E = 72) with experts
    0-7 held), on the top k of uniform scores: bitwise its plain version
    (the one-hot cumulative sum), then both timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_positions import ops, ref
    from repro_torch.models.moe import expert_capacity
    records = {}
    for name, (arch, tokens, held) in MOE_POSITION_SHAPES.items():
        cfg = get_config(arch)
        e, k = cfg.num_experts, cfg.top_k
        cap = expert_capacity(tokens, cfg)
        scores = torch.rand(tokens, e, generator=gen, device=dev)
        flat_e = torch.sort(scores, dim=-1, descending=True,
                            stable=True)[1][:, :k].reshape(-1)

        def kernel():
            return ops.moe_positions(flat_e, e, 0, held, cap)

        def plain():
            return ref.moe_positions_ref(flat_e, e, 0, held, cap)
        for mine, want, what in zip(kernel(), plain(), ("slot", "keep")):
            if not torch.equal(mine, want):
                raise AssertionError(f"{name}: {what} differs from the "
                                     f"plain version")
        warm_up(kernel)
        ks = [cuda_ms(kernel, 50) for _ in range(8)]
        n = flat_e.numel()
        rec = dict(max_abs_err=0.0, ms=sum(ks) / len(ks),
                   ms_range=[min(ks), max(ks)],
                   plain_ms=cuda_ms(plain, 5, ahead=False), library_ms=None,
                   bound_ms=17 * n / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        records[name] = rec
        say("kernels", f"{name} at ({n:,}, E = {e}), experts 0-{held - 1} "
                       f"held, cap {cap}: bitwise the plain version; "
                       f"{rec['ms'] * 1e3:.2f} us [{min(ks) * 1e3:.2f}-"
                       f"{max(ks) * 1e3:.2f}] against the plain "
                       f"{rec['plain_ms']:.4f} ms and the byte bound "
                       f"{rec['bound_ms'] * 1e3:.3f} us")
    return records


ADAMW_BYTES = 28          # g, p, m, v read and p, m, v written, 4 B each


def adamw_args(step: int) -> dict:
    """The runtimes' AdamW (``adamw(lr)`` with its defaults) at ``step``,
    bias corrections as ``adamw().update`` takes them."""
    t = np.float32(step)
    return dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                b1c=float(np.float32(1.0) - np.float32(0.9) ** t),
                b2c=float(np.float32(1.0) - np.float32(0.999) ** t))


def check_adamw(gen, dev, specs) -> dict:
    """The AdamW kernel at the training cells' buffers (granite-3-2b's
    embedding and one of its blocks, granite-4.0-h-small's table): two
    steps bitwise its plain loop, then both timed at step 3, and
    PyTorch's fused AdamW (``torch._fused_adamw_``, other roundings) as the
    library's time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import ops, ref
    hybrid = get_config("granite-4.0-h-small")
    shapes = {"adamw@embed": specs[0].total, "adamw@block": specs[1].total,
              "adamw@table": hybrid.vocab_size * hybrid.d_model}
    records = {}
    for name, n in shapes.items():
        g = torch.randn(n, generator=gen, device=dev)
        kernel = [torch.randn(n, generator=gen, device=dev),
                  torch.zeros(n, device=dev), torch.zeros(n, device=dev)]
        plain = [x.clone() for x in kernel]
        for step in (1, 2):
            ops.adamw_update(g, *kernel, **adamw_args(step))
            ref.adamw_update_ref(g, *plain, **adamw_args(step))
        for a, b, what in zip(kernel, plain, "pmv"):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"{name}: {what} differs from the "
                                     f"plain loop")
        del plain
        args = adamw_args(3)

        def fused():
            ops.adamw_update(g, *kernel, **args)

        def loop():
            ref.adamw_update_ref(g, *kernel, **args)

        def library():
            torch._fused_adamw_(
                [kernel[0]], [g], [kernel[1]], [kernel[2]], [], [steps],
                lr=args["lr"], beta1=args["b1"], beta2=args["b2"],
                weight_decay=0.0, eps=args["eps"], amsgrad=False,
                maximize=False)
        steps = torch.full((), 3.0, device=dev)
        warm_up(fused)
        ks = [cuda_ms(fused, 10) for _ in range(8)]
        try:
            library_ms = cuda_ms(library, 10)
        except (AttributeError, RuntimeError, TypeError) as e:
            say("kernels", f"{name}: no library time ({e})")
            library_ms = None
        rec = dict(max_abs_err=0.0, ms=sum(ks) / len(ks),
                   ms_range=[min(ks), max(ks)],
                   plain_ms=cuda_ms(loop, 3, ahead=False),
                   library_ms=library_ms,
                   bound_ms=ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        records[name] = rec
        say("kernels", f"{name} at {n:,} entries: bitwise the plain loop "
                       f"over 2 steps; {rec['ms']:.4f} ms [{min(ks):.4f}-"
                       f"{max(ks):.4f}], {rec['bound_ms'] / rec['ms']:.1%} "
                       f"of the byte bound {rec['bound_ms']:.4f} ms; the "
                       f"plain loop {rec['plain_ms']:.4f} ms")
        del g, kernel
        free_cuda()
    return records


def phase_kernels(arch, plan, specs) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    check_bucket_kernels(gen, dev)
    records = time_bucket_kernels(gen, dev, plan, specs)
    free_cuda()
    records.update(check_flash(gen, dev, arch))
    free_cuda()
    check_compress_kernels(gen, dev)
    records.update(time_compress_kernels(gen, dev, specs))
    free_cuda()
    records.update(check_rglru(gen, dev))
    free_cuda()
    records.update(check_moe_positions(gen, dev))
    free_cuda()
    records.update(check_adamw(gen, dev, specs))
    for name, r in records.items():
        lib = r["library_ms"]
        say("kernels", f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f},"
                       f" library {'none' if lib is None else f'{lib:.4f}'},"
                       f" bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return records


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase_main(profile: bool) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import (RuntimeConfig, ScheduleConfig,
                                     build_runtime)
    config = RuntimeConfig(**MAIN, schedule=ScheduleConfig(
        strategy="dynacomm"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = build_runtime(config)
    torch.cuda.synchronize()
    plan = rt.plan
    arch = rt.arch
    say("main", f"{arch.name}: {arch.num_layers} layers, d_model "
                f"{arch.d_model}, heads {arch.num_heads}/{arch.num_kv_heads},"
                f" vocab {arch.vocab_size}; batch {config.batch} x seq "
                f"{config.seq}; built in {time.perf_counter() - t0:.1f} s")
    say("main", f"plan (dynacomm): {len(plan.forward)} pull buckets "
                f"{[len(b) for b in plan.forward]}, {len(plan.backward)} push "
                f"buckets {[len(b) for b in plan.backward]}")

    reset_launch_counts()
    losses, secs = timed_steps(rt, STEPS)
    counts = launch_counts()

    expect = expected_launches(plan, arch, ())
    if counts != expect:
        raise AssertionError(f"launches {counts} != expected {expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    steady = sum(secs[1:]) / len(secs[1:])
    tokens = config.batch * config.seq
    say("main", f"losses {losses}")
    say("main", f"step seconds {[round(s, 4) for s in secs]}; steady "
                f"{steady * 1e3:.1f} ms/step (steps 2-{STEPS}), "
                f"{tokens / steady:.1f} tokens/s; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("main", f"launches over {STEPS} steps {counts} == plan")
    peak = torch.cuda.max_memory_allocated()
    if profile:
        profile_step(rt, steady)
    del rt
    free_cuda()
    return dict(counts=counts, losses=losses, peak=peak)


def expected_launches(plan, arch, compress, steps: int = STEPS,
                      adamw: bool = True) -> dict:
    """Kernel launches over ``steps`` steps of a plan: one pack per bucket,
    one unpack per pull bucket, the flash forward twice per attention
    or latent-attention block (forward and recompute), the RG-LRU scan
    twice per RG-LRU block (forward and recompute) and its fused backward
    once, the MoE position kernel twice per MoE block (forward and
    recompute), one launch of
    each ``compress`` kernel per sched layer, and AdamW's update once per
    sched layer's buffer (none under SGD)."""
    kinds = arch.layer_kinds()
    per_step = {"bucket_pack": len(plan.forward) + len(plan.backward),
                "bucket_unpack": len(plan.forward),
                "flash_attention_fwd": 2 * sum(
                    k in ("global_attn", "local_attn", "mla")
                    for k in kinds),
                "rglru_scan": 2 * kinds.count("rglru"),
                "rglru_scan_bwd": kinds.count("rglru"),
                "moe_positions": 2 * arch.mlp_kinds().count("moe")}
    layers = sum(len(b) for b in plan.backward)
    per_step["adamw"] = layers if adamw else 0
    for name in PS_SCHEMES[0][1] + PS_SCHEMES[1][1]:
        per_step[name] = layers if name in compress else 0
    return {name: steps * n for name, n in per_step.items()}


def launches_of_plans(plans, arch, compress=(), adamw: bool = True) -> dict:
    """``expected_launches`` summed over ``(plan, steps)`` pairs: a run
    whose plan changes mid-way."""
    total: dict = {}
    for plan, steps in plans:
        for name, n in expected_launches(plan, arch, compress, steps,
                                         adamw).items():
            total[name] = total.get(name, 0) + n
    return total


def reference_push_ratio(specs, plan, scheme: str) -> float:
    """The reference's push compression ratio of one plan
    (``runtime/adapters.py::_plan_ledger`` over ``compress/compressor.py``'s
    wire formulas), computed here from the layer sizes alone."""
    push = wire = 0
    for bucket in plan.backward:
        w = 0.0
        for l in bucket:
            n = specs[l].total
            push += 4 * n
            w += (n + 4.0 * math.ceil(n / 512) if scheme == "int8" else
                  8.0 * max(1.0, math.ceil(TOPK_FRACTION * n)))
        wire += int(round(w + (8.0 if scheme == "topk" else 0.0)))
    return push / wire


def plain_compressor(scheme: str):
    """The compressor of ``scheme`` with its error-feedback round trip
    composed from the plain versions (``kernels/compress/ref.py``), out
    of place: an independent witness of the kernel path's composition
    (pad, residual add in place, the residual written by the dequantize
    kernel, the compressed rows).  ``topk_indices`` is shared: it is a
    torch op on both routes, held against the reference on the CPU."""
    from repro_torch.compress import Int8Compressor, TopKCompressor
    from repro_torch.kernels.compress import ref
    from repro_torch.kernels.compress.ops import aligned, topk_indices

    @dataclasses.dataclass(frozen=True)
    class PlainInt8(Int8Compressor):
        def feedback_roundtrip(self, flat, residual):
            corrected = flat + residual
            n = corrected.numel()
            npad = aligned(n)
            seg = torch.nn.functional.pad(corrected, (0, npad - n))[None]
            q, s = ref.quantize_pack_ref(seg, (npad,))
            out = ref.dequantize_unpack_ref(q, s, (npad,), npad)[0, :n]
            residual.copy_(ref.feedback_residual_ref(corrected, q, s))
            return out, residual

    @dataclasses.dataclass(frozen=True)
    class PlainTopK(TopKCompressor):
        def feedback_roundtrip(self, flat, residual):
            corrected = flat + residual
            n = corrected.numel()
            row = corrected[None]
            idx = topk_indices(row, (n,), self.k_for(n))
            out = ref.densify_ref(ref.sparsify_ref(row, idx), idx, n)[0]
            residual.copy_(corrected - out)
            return out, residual

    if scheme == "int8":
        return PlainInt8(error_feedback=True)
    return PlainTopK(error_feedback=True, fraction=TOPK_FRACTION)


def phase_ps(profile: bool) -> tuple:
    """3 steps each of the int8 and the top-k push at full width: the
    launches and the losses of each scheme."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import (CompressionConfig, RuntimeConfig,
                                     build_runtime)
    card = torch.cuda.get_device_properties(0).total_memory
    counts_by_scheme, losses_by_scheme = {}, {}
    for scheme, names in PS_SCHEMES:
        config = RuntimeConfig(**PS, compression=CompressionConfig(
            scheme, topk_fraction=TOPK_FRACTION if scheme == "topk"
            else None))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rt = build_runtime(config)
        torch.cuda.synchronize()
        plan, arch = rt.plan, rt.arch
        topo = rt.trainer.topology
        say("ps", f"{scheme}: {topo.num_servers} servers x "
                  f"{topo.num_workers} worker; consensus plan "
                  f"{len(plan.forward)} pull buckets "
                  f"{[len(b) for b in plan.forward]}, {len(plan.backward)} "
                  f"push buckets {[len(b) for b in plan.backward]}; built in "
                  f"{time.perf_counter() - t0:.1f} s")
        reset_launch_counts()
        losses, secs = timed_steps(rt, STEPS)
        counts = launch_counts()
        expect = expected_launches(plan, arch, names)
        if counts != expect:
            raise AssertionError(f"ps/{scheme} launches {counts} != "
                                 f"expected {expect}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"ps/{scheme}: non-finite losses {losses}")
        ratio = rt.ledger["push_compression_ratio"]
        want = reference_push_ratio(rt.trainer.specs, plan, scheme)
        if ratio != want:
            raise AssertionError(f"ps/{scheme}: push ratio {ratio!r} != the "
                                 f"formula's {want!r}")
        peak = torch.cuda.max_memory_allocated()
        if not peak < card:
            raise AssertionError(f"ps/{scheme}: peak {peak} >= card {card}")
        steady = sum(secs[1:]) / len(secs[1:])
        tokens = config.batch * config.seq
        say("ps", f"{scheme}: losses {losses}")
        say("ps", f"{scheme}: step seconds {[round(x, 4) for x in secs]}; "
                  f"steady {steady * 1e3:.1f} ms/step (steps 2-{STEPS}), "
                  f"{tokens / steady:.1f} tokens/s; peak memory "
                  f"{peak / 2**30:.2f} GiB of {card / 2**30:.2f}; push "
                  f"ratio {ratio:.4f}x == formula")
        say("ps", f"{scheme}: launches over {STEPS} steps {counts} == plan")
        counts_by_scheme[scheme] = counts
        losses_by_scheme[scheme] = losses
        if profile:
            profile_step(rt, steady, f"profile ps/{scheme}")
        del rt
        free_cuda()
        # the same steps from the same seed, pushing through the plain
        # composition of the round trip: the losses must not change a bit
        rt = build_runtime(config)
        rt.trainer = dataclasses.replace(rt.trainer,
                                         compressor=plain_compressor(scheme))
        plain = rt.fit(STEPS)
        del rt
        free_cuda()
        if plain != losses:
            gap = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
            raise AssertionError(f"ps/{scheme}: kernel path losses {losses} "
                                 f"!= plain round trip {plain} (largest "
                                 f"relative gap {gap:.3g})")
        say("ps", f"{scheme}: the plain round trip (ref.py, out of place) "
                  f"gives the same {STEPS} losses bitwise")
    return counts_by_scheme, losses_by_scheme


def timed_steps(rt, steps: int) -> tuple:
    """``steps`` losses and the host seconds of each step, the card
    synchronised at its end."""
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.extend(rt.fit(1))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return losses, secs


def sizes(plan) -> tuple:
    return (tuple(len(b) for b in plan.forward),
            tuple(len(b) for b in plan.backward))


def check_replan_buckets(plan, specs) -> None:
    """bucket_pack / bucket_unpack bitwise against their plain versions at
    the re-plan's bucket shapes (the first bucket of each size of
    ``plan``), as the step calls them: a pull packs one shard a layer and
    unpacks the gathered row, a push packs one piece a leaf and the
    padding's zero run."""
    from repro_torch.kernels.bucket_pack import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    pulls, pushes = {}, {}
    for buckets, side in ((plan.forward, pulls), (plan.backward, pushes)):
        for b in buckets:
            side.setdefault(len(b), b)
    for n, bucket in sorted(pulls.items()):
        shards = [torch.randn(specs[l].shard_size, generator=gen, device=dev)
                  for l in bucket]
        widths = [specs[l].shard_size for l in bucket]
        packed = ops.pack_ragged(shards)
        assert_bitwise(packed, ref.pack_ragged_ref(
            shards, dtype=torch.float32, device=dev),
            f"bucket_pack at a {n}-layer pull bucket")
        del shards
        for a, b in zip(ops.unpack_columns(packed, widths, 1),
                        ref.unpack_columns_ref(packed, widths, 1)):
            assert_bitwise(a, b, f"bucket_unpack at a {n}-layer pull bucket")
        del packed
        free_cuda()
    for n, bucket in sorted(pushes.items()):
        pieces = []
        for l in bucket:
            pieces += [torch.randn(k, generator=gen, device=dev)
                       for k in specs[l].sizes]
            if specs[l].padded > specs[l].total:
                pieces.append(specs[l].padded - specs[l].total)
        assert_bitwise(ops.pack_ragged(pieces), ref.pack_ragged_ref(
            pieces, dtype=torch.float32, device=dev),
            f"bucket_pack at a {n}-layer push bucket")
        del pieces
        free_cuda()
    say("dynamic", f"bucket_pack / bucket_unpack bitwise at the re-plan's "
                   f"pull buckets of {sorted(pulls)} layers and push buckets "
                   f"of {sorted(pushes)} layers")


def dynamic_config(runtime: str, **changes):
    """The main path's width under ``dynamic.json``'s network (runtime
    ``dynamic``) or ``dynamic_ps.json``'s topology (``dynamic-ps``), a
    re-plan every 2 steps."""
    from repro_torch.runtime import RuntimeConfig
    cfgs = ROOT / "examples" / "runtime_configs"
    name = "dynamic.json" if runtime == "dynamic" else "dynamic_ps.json"
    smoke = RuntimeConfig.load(str(cfgs / name))
    config = RuntimeConfig(**dict(MAIN, runtime=runtime),
                           schedule=smoke.schedule, measure=smoke.measure)
    for field, kw in changes.items():
        config = dataclasses.replace(config, **{field: dataclasses.replace(
            getattr(config, field), **kw)})
    return config


def steady_of(secs) -> float:
    """Mean seconds of the steps that are no plan's first (1 and 3)."""
    return (secs[1] + secs[3]) / 2


def phase_dynamic(main: dict, ps_losses: dict) -> dict:
    """The run-time loop at full width: the analytic ``dynamic`` run (and
    with async planning), the measured-cost run, and ``dynamic-ps`` plain
    and with int8 pushes."""
    from repro_torch.core import (Planner, costs_from_profiles,
                                  plan_from_decision)
    from repro_torch.core.buckets import flat_layer_order
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.profiles import layer_profiles
    from repro_torch.runtime import build_runtime
    from repro_torch.configs.base import InputShape
    config = dynamic_config("dynamic")
    net = config.schedule.network.build()
    free_cuda()
    arch, _, specs = main_plan_specs()

    # the plans, from the port's own core through the planner path
    profiles = layer_profiles(arch, InputShape("runtime", MAIN["seq"],
                                               MAIN["batch"], "train"))
    planner = Planner()
    want = [plan_from_decision(*planner.decide(costs_from_profiles(
        profiles, net=net.model_at(e),
        compute_flops_per_s=config.measure.compute_flops_per_s),
        "dynacomm"), arch.num_layers + 2) for e in (0, 1)]
    if tuple(sizes(p) for p in want) != DYNAMIC_PLANS:
        raise AssertionError(f"the port's core plans {[sizes(p) for p in want]}"
                             f" != {DYNAMIC_PLANS}")
    check_replan_buckets(want[1], specs)

    # -- dynamic, analytic costs: the swap at step 2 ----------------------
    runs = {}
    for async_planning in (False, True):
        cfg = dynamic_config("dynamic", schedule=dict(
            async_planning=async_planning))
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        rt = build_runtime(cfg)
        reset_launch_counts()
        losses, secs = timed_steps(rt, DYNAMIC_STEPS)
        counts = launch_counts()
        tr = rt.trainer
        runs[async_planning] = dict(
            losses=losses, secs=secs, counts=counts,
            peak=torch.cuda.max_memory_allocated(),
            events=[(e.step, e.plan_changed, e.retraced, e.plan,
                     e.scheduling_seconds, e.overhead_hidden)
                    for e in tr.events],
            collectives=[tr.collective_counts(p) for p in tr.plans_seen],
            stats=tr.planner_stats, windows=[
                costs_from_profiles(profiles, net=net.model_at(e),
                                    compute_flops_per_s=cfg.measure
                                    .compute_flops_per_s).idle_window
                for e in (0, 1)])
        if async_planning:
            tr.planner.close()
        del rt, tr
        free_cuda()
    run = runs[False]
    got = [(step, changed, retraced, plan)
           for step, changed, retraced, plan, _, _ in run["events"]]
    if got != [(0, False, True, want[0]), (2, True, True, want[1])]:
        raise AssertionError(f"dynamic events {got}")
    if run["collectives"] != [(len(p.forward), len(p.backward))
                              for p in want]:
        raise AssertionError(f"collective counts {run['collectives']}")
    expect = launches_of_plans(((want[0], 2), (want[1], 2)), arch)
    if run["counts"] != expect:
        raise AssertionError(f"dynamic launches {run['counts']} != {expect}")
    if run["losses"][:STEPS] != main["losses"]:
        raise AssertionError(f"dynamic losses {run['losses']} != main's "
                             f"{main['losses']}")
    if run["peak"] > main["peak"] + MEMORY_SLACK:
        raise AssertionError(f"dynamic peak {run['peak']} over main's "
                             f"{main['peak']} + 1 GiB")
    other = runs[True]
    if other["losses"] != run["losses"] or \
            [e[:4] for e in other["events"]] != [e[:4] for e in run["events"]]:
        raise AssertionError(f"async planning changed the run: "
                             f"{other['losses']} vs {run['losses']}")
    secs = run["secs"]
    say("dynamic", f"analytic costs, 10 -> 1 Gbps at epoch 1: plans "
                   f"{[sizes(p) for p in want]}; events (step, changed, "
                   f"first use) {[e[:3] for e in run['events']]}; "
                   f"collectives {run['collectives']} == buckets")
    say("dynamic", f"losses {run['losses']}, the first {STEPS} bitwise "
                   f"main's; launches {run['counts']} == plan sequence")
    say("dynamic", f"step ms {[round(x * 1e3, 1) for x in secs]}: plan 1 "
                   f"steady {secs[1] * 1e3:.1f}, the swap step (plan 2's "
                   f"first) {secs[2] * 1e3:.1f}, plan 2 steady "
                   f"{secs[3] * 1e3:.1f}; peak {run['peak'] / 2**30:.2f} "
                   f"GiB (main {main['peak'] / 2**30:.2f})")
    for e, window in zip(run["events"], run["windows"]):
        say("dynamic", f"re-plan at step {e[0]}: {e[4] * 1e3:.3f} ms against "
                       f"the dt + gt1 window {window * 1e3:.1f} ms "
                       f"(hidden={e[5]})")
    say("dynamic", f"async planning (the run after the sync one): same "
                   f"losses and events bitwise; steady ms/step (steps 2 and "
                   f"4) async {steady_of(other['secs']) * 1e3:.1f} against "
                   f"sync {steady_of(secs) * 1e3:.1f}; async re-plans "
                   f"{[round(e[4] * 1e3, 3) for e in other['events']]} ms; "
                   f"planner {other['stats']}")

    # -- dynamic, measured costs: epochs 0 and 1 -------------------------
    cfg = dynamic_config("dynamic", schedule=dict(reschedule_every=1),
                         measure=dict(cost_source="measured",
                                      measure_iters=1, measure_warmup=1))
    rt = build_runtime(cfg)
    tr = rt.trainer
    walls = []
    measure = tr.measured_times

    def timed_measure(*args, **kwargs):
        t0 = time.perf_counter()
        out = measure(*args, **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out
    tr.measured_times = timed_measure
    losses, costs = [], []
    for _ in range(2):
        losses.extend(rt.fit(1))
        costs.append(tr._costs)
    if losses != main["losses"][:2]:
        raise AssertionError(f"measured-cost losses {losses} != main's "
                             f"{main['losses'][:2]}")
    L = arch.num_layers + 2
    for e, c in zip(tr.events, costs):
        if not all(math.isfinite(x) and x > 0 for x in (*c.fc, *c.bc)):
            raise AssertionError(f"measured costs not finite positive: {c}")
        fresh = plan_from_decision(*Planner().decide(c, "dynacomm"), L)
        if e.plan != fresh or flat_layer_order(e.plan.forward) != \
                tuple(range(L)):
            raise AssertionError(f"epoch {e.epoch}: plan {sizes(e.plan)} != "
                                 f"the DP's {sizes(fresh)} on its costs")
    state, batch = rt._state, rt._batch_fn(2)
    busy_rows = traced(lambda: tr._step_fn(state, batch))
    busy = sum(r.self_device_time_total for r in busy_rows) / 1e3
    say("dynamic", f"measured costs (CUDA events, {cfg.measure.measure_iters}"
                   f" calls after {cfg.measure.measure_warmup} warm-up a "
                   f"layer and phase), wall {[round(w, 2) for w in walls]} s")
    for e, c in zip(tr.events, costs):
        fc, bc = c.fc * 1e3, c.bc * 1e3
        say("dynamic", f"epoch {e.epoch}: sum fc {fc.sum():.2f} ms (embed "
                       f"{fc[0]:.3f}, {L - 2} blocks {fc[1:-1].sum():.2f}, "
                       f"final {fc[-1]:.3f}), sum bc {bc.sum():.2f} ms (embed "
                       f"{bc[0]:.3f}, blocks {bc[1:-1].sum():.2f}, final "
                       f"{bc[-1]:.3f}); sum fc+bc {fc.sum() + bc.sum():.1f} "
                       f"ms; plan {sizes(e.plan)}; re-plan "
                       f"{e.scheduling_seconds * 1e3:.3f} ms against the "
                       f"dt + gt1 window {c.idle_window * 1e3:.1f} ms "
                       f"(hidden={e.overhead_hidden})")
    say("dynamic", f"a traced step of the active plan: device busy "
                   f"{busy:.1f} ms; losses {losses} bitwise main's")
    del rt, tr, state, batch
    free_cuda()

    # -- dynamic-ps, plain and int8 pushes --------------------------------
    ps_counts = {}
    for scheme in ("none", "int8"):
        cfg = dynamic_config("dynamic-ps", compression=dict(scheme=scheme))
        torch.cuda.reset_peak_memory_stats()
        rt = build_runtime(cfg)
        reset_launch_counts()
        losses, secs = timed_steps(rt, DYNAMIC_STEPS)
        counts = launch_counts()
        tr = rt.trainer
        plans = [e.plan for e in tr.events]
        compress = PS_SCHEMES[0][1] if scheme == "int8" else ()
        expect = launches_of_plans(((plans[0], 2), (plans[1], 2)), arch,
                                   compress)
        if counts != expect:
            raise AssertionError(f"dynamic-ps/{scheme} launches {counts} != "
                                 f"{expect}")
        pushes = tuple(sizes(p)[1] for p in plans)
        want_push = DYNAMIC_PS_PUSH if scheme == "none" else \
            (DYNAMIC_PS_PUSH[0],) * 2
        if pushes != want_push or sizes(plans[0])[0] != DYNAMIC_PLANS[0][0] \
                or sizes(plans[1])[0] != DYNAMIC_PLANS[0][0]:
            raise AssertionError(f"dynamic-ps/{scheme} plans "
                                 f"{[sizes(p) for p in plans]}")
        witness = main["losses"] if scheme == "none" else ps_losses["int8"]
        if losses[:STEPS] != witness:
            raise AssertionError(f"dynamic-ps/{scheme} losses {losses} != "
                                 f"{witness}")
        ratio = ""
        if scheme == "int8":
            got = rt.ledger["push_compression_ratio"]
            formula = reference_push_ratio(tr.base.specs, plans[0], "int8")
            if got != formula:
                raise AssertionError(f"dynamic-ps/int8 push ratio {got!r} != "
                                     f"{formula!r}")
            ratio = f"; push ratio {got:.4f}x == formula"
        say("dynamic", f"dynamic-ps/{scheme}: push plans {pushes} "
                       f"({'re-segmented' if tr.events[1].plan_changed else 'unchanged'}"
                       f" at step 2); losses {losses}, the first {STEPS} "
                       f"bitwise {'main' if scheme == 'none' else 'ps/int8'}'s; "
                       f"step ms {[round(x * 1e3, 1) for x in secs]}; peak "
                       f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                       f"launches {counts} == plan sequence{ratio}")
        ps_counts[scheme] = counts
        del rt, tr
        free_cuda()
    return dict(counts=run["counts"], ps_counts=ps_counts)


def phase_hybrid(profile: bool) -> dict:
    """HYBRID_STEPS ZeRO steps of full-width recurrentgemma-2b (the loss
    printed past its rise at step 3), then the first HYBRID_WITNESS_STEPS
    with the scan replaced by its plain loop."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import ssm
    from repro_torch.runtime import (RuntimeConfig, ScheduleConfig,
                                     build_runtime)
    config = RuntimeConfig(**HYBRID, schedule=ScheduleConfig(
        strategy="dynacomm"))
    card = torch.cuda.get_device_properties(0).total_memory
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = build_runtime(config)
    torch.cuda.synchronize()
    plan, arch = rt.plan, rt.arch
    kinds = arch.layer_kinds()
    say("hybrid", f"{arch.name}: {arch.num_layers} layers "
                  f"({kinds.count('rglru')} rglru, "
                  f"{kinds.count('local_attn')} local_attn), d_model "
                  f"{arch.d_model}, heads {arch.num_heads}/"
                  f"{arch.num_kv_heads} x {arch.head_dim}, lru width "
                  f"{arch.rglru_lru_width}, d_ff {arch.d_ff}, vocab "
                  f"{arch.vocab_size}, window {arch.sliding_window}; batch "
                  f"{config.batch} x seq {config.seq}; built in "
                  f"{time.perf_counter() - t0:.1f} s")
    say("hybrid", f"plan (dynacomm): {len(plan.forward)} pull buckets "
                  f"{[len(b) for b in plan.forward]}, {len(plan.backward)} "
                  f"push buckets {[len(b) for b in plan.backward]}")
    reset_launch_counts()
    losses, secs = timed_steps(rt, HYBRID_STEPS)
    counts = launch_counts()
    expect = expected_launches(plan, arch, (), HYBRID_STEPS)
    if counts != expect:
        raise AssertionError(f"hybrid launches {counts} != expected {expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"hybrid: non-finite losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    if not peak < card:
        raise AssertionError(f"hybrid: peak {peak} >= card {card}")
    steady = sum(secs[1:]) / len(secs[1:])
    tokens = config.batch * config.seq
    rises = [i + 1 for i in range(1, len(losses))
             if losses[i] > losses[i - 1]]
    say("hybrid", f"losses over {HYBRID_STEPS} steps {losses}; rises at "
                  f"steps {rises}")
    say("hybrid", f"step seconds {[round(x, 4) for x in secs]}; steady "
                  f"{steady * 1e3:.1f} ms/step (steps 2-{HYBRID_STEPS}), "
                  f"{tokens / steady:.1f} tokens/s; peak memory "
                  f"{peak / 2**30:.2f} GiB of {card / 2**30:.2f}")
    say("hybrid", f"launches over {HYBRID_STEPS} steps {counts} == plan and "
                  f"kinds")
    if profile:
        profile_step(rt, steady, "profile hybrid")
    del rt
    free_cuda()

    # the same steps from the same seed with the scan replaced by its plain
    # loop, differentiated by autograd: the losses must not change a bit
    kernel_scan = ssm.rglru_scan
    ssm.rglru_scan = rglru_scan_ref
    try:
        rt = build_runtime(config)
        reset_launch_counts()
        plain = rt.fit(HYBRID_WITNESS_STEPS)
        ran = {k: launch_counts()[k] for k in ("rglru_scan", "rglru_scan_bwd")}
    finally:
        ssm.rglru_scan = kernel_scan
    del rt
    free_cuda()
    if any(ran.values()):
        raise AssertionError(f"the plain run launched the scan kernels {ran}")
    if plain != losses[:HYBRID_WITNESS_STEPS]:
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
        raise AssertionError(f"hybrid: kernel path losses "
                             f"{losses[:HYBRID_WITNESS_STEPS]} "
                             f"!= plain scan {plain} (largest relative gap "
                             f"{gap:.3g})")
    say("hybrid", f"the plain scan (ref.py, autograd through the loop) gives "
                  f"the same first {HYBRID_WITNESS_STEPS} losses bitwise")
    return counts


# ---------------------------------------------------------------------------
# phase 7: the asynchronous PS (the paper's CNN, then granite-3-2b at full
# width)
# ---------------------------------------------------------------------------


def _fixed_cnn_batch(*_):
    """The reference's one fixed CNN batch (tests/test_ps.py::_fixed_batch),
    for every worker and attempt."""
    import numpy as np
    r = np.random.default_rng(7)
    return {"images": torch.from_numpy(
                r.normal(size=(8, 32, 32, 3)).astype(np.float32)),
            "labels": torch.from_numpy(r.integers(0, 10, size=(8,)))}


def cnn_async(device, throttle, plan=None, workers=3, staleness=1):
    """The reference's ``_async_trainer`` fixture: the small CNN from one
    seeded CPU draw, SGD 0.05, behind 10 / 1 Gbps links, on ``device``."""
    from repro_torch import tree
    from repro_torch.core import plan_from_decision
    from repro_torch.models.cnn import small_cnn_init, small_cnn_loss
    from repro_torch.optim import sgd
    from repro_torch.ps import AsyncPSTrainer, PSTopology, asymmetric_link
    params = tree.tree_map(lambda x: x.to(device), small_cnn_init(
        torch.Generator().manual_seed(0)))
    topo = PSTopology(num_servers=2, links=tuple(
        asymmetric_link(10e9, 1e9) for _ in range(workers)),
        worker_flops=(1e10,) * workers)
    return AsyncPSTrainer(
        init_layers=params["layers"],
        loss_fn=lambda ls, b: small_cnn_loss({"layers": ls}, b["images"],
                                             b["labels"]),
        optimizer=sgd(0.05), topology=topo, staleness=staleness,
        throttle=throttle, plan=plan or plan_from_decision(
            ((1, 3), (4, 5)), ((4, 5), (1, 3)), 5))


def event_rows(log) -> list:
    """(worker, version, staleness, accepted, wait_s) of each commit."""
    return [(e.worker, e.version, e.result.staleness, e.result.accepted,
             e.wait_s) for e in log.events]


def rel_gap(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def phase_async_cnn() -> None:
    """The CNN under ``reject`` and ``wait`` at k = 1 on the card against
    the port on the CPU, and the paper's Fig. 10 claim on the card."""
    from repro_torch.core import plan_from_decision, schedule
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.ps import PSTopology, asymmetric_link
    from repro_torch.ps.dynamic import profiles_from_specs
    from repro_torch.runtime.replan import sequential_plan
    card = torch.device("cuda")
    for throttle in ("reject", "wait"):
        cpu = cnn_async("cpu", throttle).run(CNN_PUSHES, _fixed_cnn_batch)
        got = cnn_async(card, throttle).run(CNN_PUSHES, _fixed_cnn_batch)
        if event_rows(got) != event_rows(cpu):
            raise AssertionError(f"CNN/{throttle}: card events "
                                 f"{event_rows(got)} != CPU "
                                 f"{event_rows(cpu)}")
        gap = rel_gap(got.losses, cpu.losses)
        if not gap <= CARD_CPU_RTOL:
            raise AssertionError(f"CNN/{throttle}: card {got.losses} vs CPU "
                                 f"{cpu.losses}: rel gap {gap:.3g}")
        say("async", f"CNN/{throttle} k=1, 3 workers, {CNN_PUSHES} accepted "
                     f"pushes: events (worker, version, staleness, accepted, "
                     f"wait_s) {event_rows(got)} == the CPU's; rejected "
                     f"{got.num_rejected}; losses {got.losses}; rel gap to "
                     f"the CPU {gap:.3g} (rtol {CARD_CPU_RTOL})")
    # Fig. 10: one worker at k = 0 under the sequential and a segmented
    # DynaComm plan; the plan changes the messages, never the math
    pipe = SyntheticCIFAR(32, seed=0)
    probe = cnn_async("cpu", "reject", workers=1, staleness=0)
    costs = PSTopology(num_servers=1, links=(asymmetric_link(1e9, 1e8),),
                       worker_flops=(1e9,)).topology_costs(
        profiles_from_specs(probe.specs, flops_per_param=1000.0))
    dyn = plan_from_decision(*schedule(costs.workers[0], "dynacomm"), 5)
    if len(dyn.forward) + len(dyn.backward) <= 2:
        raise AssertionError(f"the DynaComm plan {dyn} is not segmented")
    losses = {}
    for name, plan in (("sequential", sequential_plan(5)),
                       ("dynacomm", dyn)):
        losses[name] = cnn_async(card, "reject", plan, workers=1,
                                 staleness=0).run(
            FIG10_PUSHES, lambda w, i: pipe.batch(i)).losses
    if losses["dynacomm"] != losses["sequential"]:
        raise AssertionError(f"Fig. 10: losses differ across plans {losses}")
    say("async", f"Fig. 10 on the card (SyntheticCIFAR batch 32, "
                 f"{FIG10_PUSHES} pushes): sequential (1 / 1 messages) and "
                 f"DynaComm ({len(dyn.forward)} pull / {len(dyn.backward)} "
                 f"push segments) give the same losses bitwise: "
                 f"{losses['sequential']}")


def async_config(name: str):
    """Full-width granite-3-2b (batch 2 x seq 1024) under the checked-in
    ``name``.json's schedule, execution, optimizer and compression."""
    from repro_torch.runtime import RuntimeConfig
    smoke = RuntimeConfig.load(str(ROOT / "examples" / "runtime_configs" /
                                   f"{name}.json"))
    return dataclasses.replace(smoke, reduced=False, batch=MAIN["batch"],
                               seq=MAIN["seq"])


def async_run(config, pushes: int, model=None, hook=None) -> dict:
    """``pushes`` accepted pushes of an async runtime, each timed by the
    host clock to a synchronised card, the launches counted over them
    (``hook(runtime)`` runs between the build and the first push)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import build_runtime
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = build_runtime(config, model)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    if hook is not None:
        hook(rt)
    reset_launch_counts()
    losses, secs = timed_steps(rt, pushes)
    counts = launch_counts()
    loop = getattr(rt.trainer, "trainer", rt.trainer)
    attempts = dict(loop._loop.attempts)
    out = dict(rt=rt, loop=loop, losses=losses, secs=secs, counts=counts,
               commits=commits(rt), built=built,
               peak=torch.cuda.max_memory_allocated(),
               events=event_rows(loop.log),
               computations=sum(attempts.values()), attempts=attempts)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{config.runtime}: non-finite losses {losses}")
    return out


def witness_flash(cfg, kernel_run, arch) -> None:
    """The first ASYNC_WITNESS_PUSHES pushes from the same seed with the
    plain attention in place of the flash kernel: the same events; the
    computations pinned at version 0 (the same weights in both runs) to
    CARD_CPU_RTOL, the later ones printed (AdamW's first, sign-like steps
    carry the runs apart).
    Each of the witness's computations also takes its loss through flash
    on its own weights and batch (no_grad): flash against the plain
    attention on the same inputs, every pair to CARD_CPU_RTOL."""
    from repro_torch.kernels.flash_attention.ops import _ref_fwd
    from repro_torch.models import attention
    kernel = attention.flash_attention
    use_flash = [False]

    def switch(q, k, v, causal, window, softcap, scale=None):
        if use_flash[0]:
            return kernel(q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale)
        return _ref_fwd(q, k, v, causal, window, softcap, scale)

    pairs = []

    def hook(rt):
        grad_fn, loss_fn = rt.trainer._grad_fn, rt._loss_fn

        def witnessed(layers, batch):
            use_flash[0] = True
            try:
                with torch.no_grad():
                    flash = float(loss_fn(layers, batch))
            finally:
                use_flash[0] = False
            loss, grads = grad_fn(layers, batch)
            pairs.append((loss, flash))
            return loss, grads
        rt.trainer._grad_fn = witnessed

    attention.flash_attention = switch
    try:
        witness = async_run(cfg, ASYNC_WITNESS_PUSHES, hook=hook)
    finally:
        attention.flash_attention = kernel
    if witness["events"] != kernel_run["events"][:ASYNC_WITNESS_PUSHES]:
        raise AssertionError(f"witness events {witness['events']} != "
                             f"{kernel_run['events']}")
    flash_launches = witness["counts"]["flash_attention_fwd"]
    attn = sum(k in ("global_attn", "local_attn") for k in arch.layer_kinds())
    gaps = [abs(a - b) / abs(b) for a, b in zip(kernel_run["losses"],
                                                witness["losses"])]
    pinned0 = [g for g, e in zip(gaps, kernel_run["events"]) if e[1] == 0]
    same = max(abs(p - f) / abs(p) for p, f in pairs)
    say("async", f"ps-async: plain-attention witness: the same events; "
                 f"losses {witness['losses']}; rel gap to the kernel run by "
                 f"push {[float(f'{g:.3g}') for g in gaps]} (the pushes "
                 f"computed at version 0, on the same weights: "
                 f"{[float(f'{g:.3g}') for g in pinned0]}, rtol "
                 f"{CARD_CPU_RTOL}); peak {witness['peak'] / 2**30:.2f} GiB")
    say("async", f"ps-async: flash against the plain attention on each of "
                 f"the witness's {len(pairs)} computations' own weights and "
                 f"batch: largest rel gap {same:.3g} (rtol {CARD_CPU_RTOL}); "
                 f"{flash_launches} flash launches, one per layer of each "
                 f"(no_grad)")
    if not max(pinned0) <= CARD_CPU_RTOL or not same <= CARD_CPU_RTOL:
        raise AssertionError(f"ps-async: flash against the plain attention: "
                             f"version-0 gaps {pinned0}, same-input gap "
                             f"{same:.3g} > {CARD_CPU_RTOL}")
    if flash_launches != attn * len(pairs):
        raise AssertionError(f"the witness launched flash {flash_launches} "
                             f"times, not once a layer of its "
                             f"{len(pairs)} no_grad forwards")


def check_async_launches(run, arch, compress=()) -> None:
    """Flash twice per attention block per gradient computation (forward
    and remat's recompute), each ``compress`` kernel once per sched layer
    per accepted push, AdamW once per sched layer per commit of the
    server, nothing else."""
    kinds = arch.layer_kinds()
    attn = sum(k in ("global_attn", "local_attn") for k in kinds)
    want = {name: 0 for name in run["counts"]}
    want["flash_attention_fwd"] = 2 * attn * run["computations"]
    want["adamw"] = (arch.num_layers + 2) * run["commits"]
    for name in compress:
        want[name] = (arch.num_layers + 2) * len(run["losses"])
    if run["counts"] != want:
        raise AssertionError(f"launches {run['counts']} != {want}")


def check_async_ledger(run) -> None:
    """Pull and push bytes per worker: the FlatSpec formula per segment of
    the worker's plan, times its pulls (computations) and pushes."""
    from repro_torch.dist.collectives import bucket_bytes
    loop = run["loop"]
    led, specs = loop.server.ledger, loop.specs
    pushes = loop.log.accepted_by_worker()
    for w, plan in enumerate(loop.plans):
        pull = run["attempts"][w] * sum(bucket_bytes(specs, b)
                                        for b in plan.forward)
        push = pushes.get(w, 0) * sum(bucket_bytes(specs, b)
                                      for b in plan.backward)
        if (led.pulled_bytes.get(w, 0), led.pushed_bytes.get(w, 0)) != \
                (pull, push):
            raise AssertionError(f"worker {w}: ledger {led} != the formula's "
                                 f"pull {pull} / push {push}")


def report_async(tag: str, run) -> None:
    secs = run["secs"]
    steady = sum(secs[1:]) / len(secs[1:])
    say("async", f"{tag}: events (worker, version, staleness, accepted, "
                 f"wait_s) {run['events']}")
    say("async", f"{tag}: losses {run['losses']}")
    say("async", f"{tag}: built in {run['built']:.1f} s; push seconds "
                 f"{[round(x, 4) for x in secs]}; steady "
                 f"{steady * 1e3:.1f} ms/push (pushes 2-{len(secs)}, one "
                 f"gradient computation each); {run['computations']} "
                 f"computations; peak memory {run['peak'] / 2**30:.2f} GiB")
    say("async", f"{tag}: launches {run['counts']}; ledger "
                 f"{run['rt'].ledger}")


def phase_async(profile: bool) -> None:
    """The CNN, then ps-async plain (with a plain-attention witness),
    dynamic-ps-async plain and ps-async int8 at 20 layers (with the plain
    round-trip witness) at granite-3-2b's full width."""
    from repro_torch.configs import get_config
    from repro_torch.core import plan_from_decision, schedule
    from repro_torch.kernels import launch_counts, reset_launch_counts
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        phase_async_cnn()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    card = torch.cuda.get_device_properties(0).total_memory
    arch = get_config(MAIN["arch"])

    # -- ps-async, plain pushes, full depth ------------------------------
    cfg = async_config("ps_async")
    run = async_run(cfg, ASYNC_PUSHES)
    topo = run["loop"].topology
    say("async", f"ps-async: {arch.name} full width, {arch.num_layers} "
                 f"layers; {topo.num_servers} servers x {topo.num_workers} "
                 f"workers, k={cfg.execution.staleness} "
                 f"({cfg.execution.throttle}), {cfg.optimizer}; plan "
                 f"{sizes(run['loop'].plan)}")
    check_async_launches(run, arch)
    check_async_ledger(run)
    report_async("ps-async", run)
    if profile:
        profile_step(run["rt"], sum(run["secs"][1:]) / len(run["secs"][1:]),
                     "profile ps-async")
    if not run["peak"] < card:
        raise AssertionError(f"ps-async: peak {run['peak']} >= card {card}")
    plain = {k: v for k, v in run.items() if k not in ("rt", "loop")}
    del run
    witness_flash(cfg, plain, arch)

    # -- dynamic-ps-async, plain pushes, full depth ----------------------
    cfg = async_config("dynamic_ps_async")
    run = async_run(cfg, ASYNC_PUSHES)
    tr = run["rt"].trainer
    check_async_launches(run, arch)
    check_async_ledger(run)
    L = arch.num_layers + 2
    for e in tr.events:
        costs = tr.costs_for_epoch(e.epoch)
        want = tuple(plan_from_decision(*schedule(c, "dynacomm"), L)
                     for c in costs.workers)
        if e.worker_plans != want:
            raise AssertionError(f"epoch {e.epoch}: plans "
                                 f"{[sizes(p) for p in e.worker_plans]} != "
                                 f"the port's core {[sizes(p) for p in want]}")
        say("async", f"dynamic-ps-async: re-plan epoch {e.epoch} at push "
                     f"{e.at_push}: per-worker plans "
                     f"{[sizes(p) for p in e.worker_plans]} == the port's "
                     f"core; {'re-segmented' if e.plan_changed else 'unchanged'}"
                     f"; sched {e.scheduling_seconds * 1e3:.3f} ms against the "
                     f"dt + gt1 window {costs.idle_window * 1e3:.1f} ms "
                     f"(hidden={e.overhead_hidden})")
    report_async("dynamic-ps-async", run)
    same = [r[:4] for r in run["events"]] == [r[:4] for r in plain["events"]]
    if not same or run["losses"] != plain["losses"]:
        raise AssertionError(f"dynamic-ps-async: events {run['events']} / "
                             f"losses {run['losses']} != ps-async's "
                             f"{plain['events']} / {plain['losses']}")
    say("async", f"dynamic-ps-async: the same commit order as ps-async (two "
                 f"identical workers) and its losses bitwise")
    del run, tr

    # -- ps-async, int8 pushes, 20 layers --------------------------------
    cfg = async_config("ps_async_int8")
    cut = dataclasses.replace(arch, num_layers=ASYNC_INT8_LAYERS)
    names = PS_SCHEMES[0][1]
    run = async_run(cfg, ASYNC_INT8_PUSHES, cut)
    check_async_launches(run, cut, names)
    check_async_ledger(run)
    ratio = run["rt"].ledger["push_compression_ratio"]
    want = reference_push_ratio(run["loop"].specs, run["loop"].plan, "int8")
    if ratio != want:
        raise AssertionError(f"ps-async int8: push ratio {ratio!r} != the "
                             f"formula's {want!r}")
    say("async", f"ps-async int8: {cut.num_layers} layers (the one depth cut), "
                 f"plan {sizes(run['loop'].plan)}; push ratio {ratio:.4f}x == "
                 f"formula")
    report_async("ps-async int8", run)
    losses = run["losses"]
    del run
    free_cuda()
    from repro_torch.runtime import build_runtime
    rt = build_runtime(cfg, cut)
    rt.trainer.compressor = plain_compressor("int8")
    reset_launch_counts()
    witness = rt.fit(ASYNC_INT8_PUSHES)
    ran = {k: launch_counts()[k] for k in names}
    del rt
    free_cuda()
    if any(ran.values()) or witness != losses:
        raise AssertionError(f"ps-async int8: plain round trip {witness} "
                             f"(launches {ran}) != kernel path {losses}")
    say("async", f"ps-async int8: the plain round trip (ref.py, out of "
                 f"place) gives the same {ASYNC_INT8_PUSHES} losses bitwise")


# ---------------------------------------------------------------------------
# phase 8: the elastic fleet at full width
# ---------------------------------------------------------------------------


def fleet_config(arch):
    """``fleet_async.json``'s topology, execution, optimizer and
    ``workers_per_shard`` at ``arch``'s full width (batch 2 x seq 1024),
    its schedule scaled to T, one worker iteration of ``arch`` under the
    initial fleet's plan.  Returns (config, T)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core import schedule
    from repro_torch.core.costmodel import iteration_time
    from repro_torch.models.profiles import layer_profiles
    from repro_torch.runtime import RuntimeConfig
    from repro_torch.runtime.config import FleetEventConfig
    smoke = RuntimeConfig.load(str(ROOT / "examples" / "runtime_configs" /
                                   "fleet_async.json"))
    shape = InputShape("runtime", MAIN["seq"], MAIN["batch"], "train")
    costs = smoke.schedule.topology.build(default_workers=1).topology_costs(
        layer_profiles(arch, shape))
    decision = schedule(costs.workers[0], smoke.schedule.strategy)
    T = iteration_time(costs.workers[0], *decision)
    events = tuple(FleetEventConfig(time=at * T, kind=kind, worker=w)
                   for at, kind, w in FLEET_EVENTS)
    return dataclasses.replace(
        smoke, reduced=False, batch=MAIN["batch"], seq=MAIN["seq"],
        fleet=dataclasses.replace(smoke.fleet, events=events)), T


def fleet_on_the_cpu(config, arch, pushes: int):
    """The port's ``FleetTrainer`` on the CPU over toy layers (4 floats a
    sched layer) with ``config``'s specs, schedule and detectors and
    ``arch``'s full-width profiles: its event stream is a pure function of
    those, so it is the card run's."""
    from repro_torch.configs.base import InputShape
    from repro_torch.fleet import FleetTrainer, WorkerSpec
    from repro_torch.models.profiles import layer_profiles
    profiles = layer_profiles(arch, InputShape("runtime", config.seq,
                                               config.batch, "train"))
    topo = config.schedule.topology.build(default_workers=1)
    specs = {w: WorkerSpec(link.down.bandwidth_bps, link.up.bandwidth_bps,
                           topo.worker_flops[w])
             for w, link in enumerate(topo.links)}
    fleet = config.fleet
    tr = FleetTrainer(
        init_layers=[{"w": torch.full((4,), 0.1)} for _ in profiles],
        loss_fn=lambda ls, b: sum(torch.sum(x["w"] ** 2) for x in ls),
        optimizer=config.build_optimizer(), workers=specs,
        schedule=fleet.build_schedule(tuple(specs)),
        num_servers=topo.num_servers,
        workers_per_shard=fleet.workers_per_shard,
        staleness=config.execution.staleness or 0,
        throttle=config.execution.throttle,
        strategy=config.schedule.strategy, profiles=profiles,
        drift_detector=fleet.build_detector(),
        stall_factor=fleet.stall_factor, check_interval=fleet.check_interval,
        async_planning=config.schedule.async_planning,
        plan_cache_size=config.schedule.plan_cache_size)
    tr.run(pushes, lambda w, i: {})
    return tr


def fleet_stream(tr) -> dict:
    """A fleet run's event streams without the wall-clock fields and the
    migrated bytes (toy layers move fewer): membership changes, re-plans,
    commits, push histories, plans and computations per worker."""
    return dict(
        membership=[dataclasses.asdict(e) for e in tr.membership_events],
        replans=[(e.sim_time, e.at_push, e.reason, e.worker, e.num_workers,
                  e.num_servers, e.plan_changed, e.resharded)
                 for e in tr.replan_events],
        commits=[(e.worker, e.sim_time, e.version, e.result.staleness,
                  e.result.accepted, e.wait_s) for e in tr.log.events],
        history={w: tuple(((p.forward, p.backward), n, x)
                          for p, n, x in h)
                 for w, h in tr.push_history.items()},
        plans={w: (p.forward, p.backward) for w, p in tr.plans.items()},
        attempts=dict(tr._loop.attempts))


def history_runs(tr) -> dict:
    """{worker: [(whole pushes, partial segments) of each plan's run]}."""
    return {w: [(n, x) for _, n, x in h] for w, h in tr.push_history.items()}


def check_fleet_ledger(run) -> None:
    """Pulled bytes = computations x the model's bytes; pushed bytes =
    each push-history run's whole pushes plus its partial segments, by the
    FlatSpec formula per segment."""
    from repro_torch.dist.collectives import bucket_bytes
    tr = run["loop"]
    led, specs = tr.server.ledger, tr.specs
    whole = bucket_bytes(specs, range(len(specs)))
    for w, hist in tr.push_history.items():
        push = sum(n * whole + sum(bucket_bytes(specs, b)
                                   for b in p.backward[:x])
                   for p, n, x in hist)
        if led.pushed_bytes.get(w, 0) != push:
            raise AssertionError(f"worker {w}: pushed "
                                 f"{led.pushed_bytes.get(w, 0)} != the "
                                 f"formula's {push} over {hist}")
    for w, n in run["attempts"].items():
        if led.pulled_bytes.get(w, 0) != n * whole:
            raise AssertionError(f"worker {w}: pulled "
                                 f"{led.pulled_bytes.get(w, 0)} != {n} x "
                                 f"{whole}")


def migration_formula(tr) -> tuple:
    """(bytes, reshards) the re-plans' shard counts imply: each layer
    whose owning shard changed ships its parameters and its AdamW
    moments (3 f32 copies)."""
    from repro_torch.ps import PSTopology
    L, moved_bytes, count = len(tr.specs), 0, 0
    shards = tr.replan_events[0].num_servers
    for e in tr.replan_events[1:]:
        if e.num_servers != shards:
            old, new = (PSTopology.uniform(n, 1) for n in (shards,
                                                          e.num_servers))
            moved_bytes += 3 * sum(
                tr.specs[l].total * 4 for l in range(L)
                if old.shard_of_layer(l, L) != new.shard_of_layer(l, L))
            count += 1
        shards = e.num_servers
    return moved_bytes, count


def watch_reshard(rt, seen: list) -> None:
    """Wrap the runtime's server's ``reshard``: before it, clone every
    retained snapshot below the head on the card; after it, pull each
    pinned version again and hold it to the clone bitwise.  The clones
    take the place of the departing worker's payload, freed just before
    the re-plan, so the run's peak does not move."""
    server = rt.trainer.server
    real = server.reshard

    def reshard(topology):
        bucket = tuple(range(server.num_layers))
        pins = [v for v in server.snapshot_versions if v < server.version]
        before = {v: {l: f.clone() for l, f in
                      server.pull_bucket(bucket, version=v)[1].items()}
                  for v in pins}
        info = real(topology)
        for v in pins:
            _, after = server.pull_bucket(bucket, version=v)
            for l in bucket:
                assert_bitwise(after[l], before[v].pop(l),
                               f"version {v} layer {l} across the reshard")
        seen.append((pins, info))
        return info
    server.reshard = reshard


def fleet_resume_witness(arch) -> None:
    """At full width and FLEET_RESUME_LAYERS layers, under the same
    schedule scaled to that model's T: run FLEET_RESUME_PUSHES pushes,
    ``save_state`` (the server tree and ``.loop``), run as many more; a
    fresh runtime restored from the checkpoint gives the same log, events,
    ledger and parameters bitwise."""
    import tempfile
    from repro_torch.runtime import build_runtime
    cut = dataclasses.replace(arch, num_layers=FLEET_RESUME_LAYERS)
    cfg, T = fleet_config(cut)
    n = FLEET_RESUME_PUSHES
    (ROOT / "build").mkdir(exist_ok=True)               # ignored by git
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "fleet.npz")
        free_cuda()
        rt = build_runtime(cfg, cut)
        rt.fit(n)
        rt.save_state(path)
        later = rt.fit(n)
        full = fleet_stream(rt.trainer)
        losses = rt.trainer.log.losses
        flats = [f.cpu() for f in rt.trainer.server.flats()]
        ledger = dataclasses.asdict(rt.trainer.server.ledger)
        del rt
        free_cuda()
        resumed = build_runtime(cfg, cut)
        resumed.restore_state(path)
        again = resumed.fit(n)
        got = fleet_stream(resumed.trainer)
        same_flats = all(torch.equal(a.cpu(), b) for a, b in
                         zip(resumed.trainer.server.flats(), flats))
        same = (got == full and again == later and same_flats and
                resumed.trainer.log.losses == losses and
                dataclasses.asdict(resumed.trainer.server.ledger) == ledger)
        kinds = [e["kind"] for e in got["membership"]]
        del resumed
        free_cuda()
    if not same:
        raise AssertionError(f"fleet resume: {again} != {later}, or the "
                             f"events, ledger or parameters differ")
    say("fleet", f"resume witness at {FLEET_RESUME_LAYERS} layers of full "
                 f"width (T = {T:.3f} simulated s): {n} pushes, save_state, "
                 f"{n} more; a fresh runtime restored from the checkpoint "
                 f"gives the log, the membership events {kinds}, the "
                 f"re-plans, the ledger and the parameters bitwise "
                 f"(losses {later})")


def phase_fleet(smi: str) -> None:
    """``fleet-async`` at granite-3-2b's full width under a join, a crash
    in flight and a leave that re-shards; then the resume witness."""
    from repro_torch.configs import get_config
    arch = get_config(MAIN["arch"])
    cfg, T = fleet_config(arch)
    t0 = time.perf_counter()
    cpu = fleet_on_the_cpu(cfg, arch, FLEET_PUSHES)
    cpu_s = time.perf_counter() - t0
    seen = []
    run = async_run(cfg, FLEET_PUSHES,
                    hook=lambda rt: watch_reshard(rt, seen))
    tr = run["loop"]
    stream = fleet_stream(tr)
    if stream != fleet_stream(cpu):
        raise AssertionError(f"fleet: the card's stream {stream} != the "
                             f"CPU's {fleet_stream(cpu)}")
    for e in tr.membership_events:
        say("fleet", f"t = {e.sim_time / T:.2f} T: {e.kind} worker "
                     f"{e.worker} (fleet size {e.fleet_size})")
    for e in tr.replan_events:
        say("fleet", f"t = {e.sim_time / T:.2f} T @push {e.at_push}: re-plan "
                     f"({e.reason}, worker {e.worker}): {e.num_workers} "
                     f"workers, {e.num_servers} shards, "
                     f"{'re-segmented' if e.plan_changed else 'unchanged'}"
                     f"{', resharded' if e.resharded else ''}, "
                     f"{e.migrated_bytes} bytes moved; sched "
                     f"{e.scheduling_seconds * 1e3:.3f} ms "
                     f"(hidden={e.overhead_hidden})")
    say("fleet", f"{arch.name} full width, {arch.num_layers} layers; T = "
                 f"{T:.1f} simulated s; plan {sizes(tr.plans[0])}; events, "
                 f"re-plans, commits, push histories, plans and "
                 f"computations {run['attempts']} == the port's "
                 f"FleetTrainer on the CPU over {len(tr.specs)} toy layers "
                 f"with the full-width profiles ({cpu_s:.1f} s)")
    log = tr.log
    if log.max_staleness > cfg.execution.staleness or \
            len(log.accepted) != FLEET_PUSHES:
        raise AssertionError(f"fleet: {len(log.accepted)} accepted, max "
                             f"staleness {log.max_staleness}")
    check_async_launches(run, arch)
    check_fleet_ledger(run)
    kinds = {e.kind for e in tr.membership_events}
    if kinds != {"join", "crash", "leave"} or \
            not any(x for h in tr.push_history.values() for _, _, x in h):
        raise AssertionError(f"fleet: membership {kinds}, history "
                             f"{tr.push_history}: no crash in flight")
    moved, reshards = migration_formula(tr)
    led = tr.server.ledger
    if (led.migrated_bytes, led.num_reshards) != (moved, reshards) or \
            reshards != 1 or sum(e.migrated_bytes
                                 for e in tr.replan_events) != moved:
        raise AssertionError(f"fleet: migrated {led.migrated_bytes} in "
                             f"{led.num_reshards} != the formula's {moved} "
                             f"in {reshards}")
    if len(seen) != 1 or not seen[0][0]:
        raise AssertionError(f"fleet: the reshard pinned {seen}")
    say("fleet", f"max staleness {log.max_staleness}; launches "
                 f"{run['counts']} (flash = 2 x {arch.num_layers} x "
                 f"{run['computations']} computations, the crash's and the "
                 f"leave's included); ledger per worker == the segment "
                 f"formula over the push histories "
                 f"{history_runs(tr)}")
    say("fleet", f"reshard 2 -> 1 shards: {led.migrated_bytes} bytes "
                 f"migrated in {led.num_reshards} == the formula; pulls "
                 f"pinned at versions {seen[0][0]} bitwise across it")
    secs = run["secs"]
    steady = sum(secs[1:]) / len(secs[1:])
    copy = sum(s.total * 4 for s in tr.specs) / 2**30
    k = cfg.execution.staleness
    reckoned = (3 + k + k + 1) * copy + ACTIVATION_GIB
    peak = run["peak"] / 2**30
    say("fleet", f"losses {run['losses']}")
    say("fleet", f"push seconds {[round(x, 4) for x in secs]}: first "
                 f"{secs[0]:.3f} s, steady {steady * 1e3:.1f} ms a push "
                 f"(pushes 2-{len(secs)}); built in {run['built']:.1f} s; "
                 f"peak {peak:.2f} GiB against the reckoning {reckoned:.2f} "
                 f"(3 + k server copies, k + 1 payloads of {copy:.2f} GiB, "
                 f"~{ACTIVATION_GIB} GiB activations); {smi}")
    if not peak < reckoned + copy / 2:
        raise AssertionError(f"fleet: peak {peak:.2f} GiB: a departed "
                             f"worker's payload outlived its slot")
    del run, tr, cpu
    free_cuda()
    fleet_resume_witness(arch)


# ---------------------------------------------------------------------------
# phase 9: the pipeline runtime at full width
# ---------------------------------------------------------------------------


def pipeline_config(arch: str = MAIN["arch"]):
    """The main path's batch and seed (its model by default) under
    ``pipeline.json``'s pipeline block (S = 2, M = 2, 1f1b, 1 chunk) and
    network."""
    from repro_torch.runtime import RuntimeConfig
    smoke = RuntimeConfig.load(str(ROOT / "examples" / "runtime_configs" /
                                   "pipeline.json"))
    return RuntimeConfig(**dict(MAIN, runtime="pipeline", arch=arch),
                         pipeline=smoke.pipeline, schedule=smoke.schedule,
                         measure=smoke.measure)


def check_pipeline_flash(arch, config, dev) -> float:
    """Flash at the pipeline path's call, before the path runs: one
    micro-batch of batch / M sequences, (B, T, H, hd) views, causal, f32,
    against its plain version."""
    from repro_torch.kernels.flash_attention.ops import (_ref_fwd,
                                                         flash_attention)
    b = config.batch // config.pipeline.microbatches
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = _qkv(gen, dev, b, arch.num_heads, arch.num_kv_heads,
                   config.seq, arch.head_dim, torch.float32, True)
    with torch.no_grad():
        err = (flash_attention(q, k, v, True, 0, 0.0)
               - _ref_fwd(q, k, v, True, 0, 0.0)).abs().max().item()
    if not err <= F32_ATOL:
        raise AssertionError(f"flash at the pipeline path's shape: max abs "
                             f"err {err:.3g} > {F32_ATOL}")
    say("pipeline", f"flash_attention_fwd at the pipeline path's (B={b}, "
                    f"H={arch.num_heads}/{arch.num_kv_heads}, T={config.seq},"
                    f" hd={arch.head_dim}) f32 views: max abs err {err:.3g} "
                    f"against its plain version (atol {F32_ATOL})")
    return err


def pipeline_ledger_formula(tr, steps: int) -> dict:
    """The ledger of ``steps`` steps: a pull of each micro-batch's
    activation and a push of its gradient at every boundary, and with
    S > 1 one pull of the embedding to the head's stage and a push of its
    gradient back per micro-batch."""
    S, M = tr.num_stages, tr.num_microbatches
    act = tr.activation_bytes()
    embed = tr.specs[0].total * 4 if S > 1 else 0
    pulls = steps * (M * (S - 1) + (S > 1))
    pushes = steps * (M * (S - 1) + M * (S > 1))
    pull_bytes = steps * (M * sum(act) + embed)
    push_bytes = steps * M * (sum(act) + embed)
    return {"num_pulls": pulls, "num_pushes": pushes,
            "pull_bytes": pull_bytes, "push_bytes": push_bytes,
            "pull_wire_bytes": pull_bytes, "push_wire_bytes": push_bytes}


def pipeline_witness(arch, dev) -> None:
    """At PIPELINE_WITNESS_LAYERS blocks of full width, 2 steps each: the
    losses and parameters bitwise across S at M = 1, between S = 2 and 4
    at M = 2, between gpipe and 1f1b, and with the stages placed on the
    card by ``stage_devices`` against ``None``; the S = 1 against S = 2 gap
    at M = 2 (the tied embedding's gradient grouping) printed."""
    from repro_torch.data.pipeline import SyntheticText
    from repro_torch.optim import adamw
    from repro_torch.pipeline import PipelineTrainer
    small = dataclasses.replace(arch, num_layers=PIPELINE_WITNESS_LAYERS)
    data = SyntheticText(small.vocab_size, MAIN["seq"], MAIN["batch"],
                         seed=0)

    def run(S, M, name="1f1b", devices=None):
        tr = PipelineTrainer(cfg=small, optimizer=adamw(3e-4), device=dev,
                             num_stages=S, num_microbatches=M,
                             schedule_name=name, stage_devices=devices)
        state = tr.init_state(torch.Generator(device=dev).manual_seed(0))
        losses = []
        for i in range(2):
            state, loss = tr.step(state, data.batch(i))
            losses.append(float(loss))
        out = (losses, [f.clone() for f in state["flat_params"]])
        del state, tr
        free_cuda()
        return out

    def same(a, b, what):
        if a[0] != b[0] or any(not torch.equal(bits(x), bits(y))
                               for x, y in zip(a[1], b[1])):
            raise AssertionError(f"pipeline witness: {what}: losses "
                                 f"{a[0]} vs {b[0]}")

    one = {S: run(S, 1) for S in (1, 2, 4)}
    same(one[1], one[2], "S = 1 vs S = 2 at M = 1")
    same(one[1], one[4], "S = 1 vs S = 4 at M = 1")
    ones = one[1][0]
    del one
    two = {S: run(S, 2) for S in (1, 2, 4)}
    same(two[2], two[4], "S = 2 vs S = 4 at M = 2")
    same(two[2], run(2, 2, "gpipe"), "gpipe vs 1f1b at S = 2, M = 2")
    same(two[2], run(2, 2, devices=[dev, dev]),
         "stage_devices=[cuda:0] * 2 vs None")
    gap = max(abs(a - b) / abs(b) for a, b in zip(two[1][0], two[2][0]))
    say("pipeline", f"witness at {PIPELINE_WITNESS_LAYERS} blocks of full "
                    f"width, 2 steps: losses and parameters bitwise across "
                    f"S = 1, 2, 4 at M = 1 ({ones})")
    say("pipeline", f"witness: bitwise S = 2 vs S = 4 at M = 2 "
                    f"({two[2][0]}), gpipe vs 1f1b, stage_devices=[cuda:0] "
                    f"x 2 vs None; S = 1 vs S = 2 at M = 2 (the embedding "
                    f"grouping, not asserted): {two[1][0]} vs {two[2][0]}, "
                    f"rel gap {gap:.3g}")


def run_pipeline_path(config, segments, phase: str) -> dict:
    """Build ``config``'s pipeline on the card and run STEPS steps: the
    partition against ``segments``, flash 3 times an attention block and
    micro-batch (the forward, the stage's recompute, the VJP's recompute),
    on an MoE the position kernel 3 times a block and micro-batch, AdamW
    once a layer's buffer a step, and no other kernel, no collective and
    no process group, the ledger against its formula, finite losses, and the peak against 4 copies of
    the parameters (parameters, mu, nu, gradient accumulators) +
    PIPELINE_ACTIVATION_GIB + 1 GiB."""
    from repro_torch.dist.collectives import collective_counts
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import build_runtime
    drop_group()                    # the pipeline needs no process group
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = build_runtime(config)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    arch, tr, part = rt.arch, rt.trainer, rt.partition
    if part.segments != segments:
        raise AssertionError(f"{phase}: partition {part.segments} != "
                             f"{segments}")
    gib = [sum(tr.specs[l].total for l in part.layers_of(s)) * 4 / 2**30
           for s in range(tr.num_stages)]
    say(phase, f"{arch.name} full width, batch {config.batch} x seq "
               f"{config.seq}, S = {tr.num_stages}, M = "
               f"{tr.num_microbatches} ({tr.schedule_name}); partition "
               f"{part.segments}, loads {[round(x, 2) for x in part.loads]}"
               f" s at {config.measure.compute_flops_per_s:g} FLOP/s; stage "
               f"parameters {[round(g, 2) for g in gib]} GiB; built in "
               f"{built:.1f} s")
    collectives = collective_counts()
    reset_launch_counts()
    losses, secs = timed_steps(rt, STEPS)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if collective_counts() != collectives or \
            torch.distributed.is_initialized():
        raise AssertionError(f"{phase}: a collective or a process group")
    attn = sum(k in ("global_attn", "local_attn")
               for k in arch.layer_kinds())
    flash = 3 * attn * tr.num_microbatches * STEPS
    routes = 3 * arch.num_layers * tr.num_microbatches * STEPS \
        if arch.is_moe else 0
    updates = STEPS * len(tr.specs) if config.optimizer == "adamw" else 0
    if counts.pop("flash_attention_fwd") != flash or \
            counts.pop("moe_positions") != routes or \
            counts.pop("adamw") != updates or any(counts.values()):
        raise AssertionError(f"{phase}: launches {launch_counts()}, want "
                             f"flash {flash}, moe_positions {routes}, adamw "
                             f"{updates} and nothing else")
    led, want = rt.ledger, pipeline_ledger_formula(tr, STEPS)
    if {k: led[k] for k in want} != want or \
            led["boundary_pull_bytes"].keys() != {0, -1}:
        raise AssertionError(f"{phase}: ledger {led} != the formula {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite losses {losses}")
    copy = sum(s.total * 4 for s in tr.specs) / 2**30
    reckoned = 4 * copy + PIPELINE_ACTIVATION_GIB
    if not peak <= reckoned + 1.0:
        raise AssertionError(f"{phase}: peak {peak:.2f} GiB > the "
                             f"reckoning {reckoned:.2f} + 1 GiB")
    say(phase, f"ledger over {STEPS} steps {want} == the formula "
               f"(activations {tr.activation_bytes()} B a micro-batch at "
               f"each boundary, the embedding {tr.specs[0].total * 4} B); "
               f"no collective ({collectives} before and after), no "
               f"process group")
    say(phase, f"launches: flash {flash} == 3 x {attn} attention blocks x "
               f"{tr.num_microbatches} micro-batches x {STEPS} steps (the "
               f"forward, the stage's recompute, the VJP's recompute); "
               f"moe_positions {routes}; no other kernel of csrc/")
    steady = sum(secs[1:]) / len(secs[1:])
    tokens = config.batch * config.seq
    say(phase, f"step seconds {[round(x, 4) for x in secs]}: first "
               f"{secs[0]:.3f} s, steady {steady * 1e3:.1f} ms/step (steps "
               f"2-{STEPS}), {tokens / steady:.1f} tokens/s; peak "
               f"{peak:.2f} GiB against the reckoning {reckoned:.2f} "
               f"(parameters, mu, nu and gradient accumulators, 4 x "
               f"{copy:.2f} GiB, + {PIPELINE_ACTIVATION_GIB} GiB)")
    return dict(rt=rt, losses=losses, steady=steady, peak=peak)


def phase_pipeline(profile: bool, smi: str, main_losses: list) -> None:
    """``pipeline`` at granite-3-2b's full width, S = 2, M = 2, 1f1b:
    flash at the path's shape, then ``run_pipeline_path``'s checks, the
    losses against the main path's, transfer plans and timeline; then the
    4-block witness."""
    from repro_torch.configs import get_config
    config = pipeline_config()
    dev = torch.device("cuda")
    check_pipeline_flash(get_config(config.arch), config, dev)
    run = run_pipeline_path(config, PIPELINE_SEGMENTS, "pipeline")
    rt, losses = run["rt"], run["losses"]
    arch = rt.arch
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, main_losses))
    if not gap <= LOSS_RTOL:
        raise AssertionError(f"pipeline: losses {losses} vs the main path's "
                             f"{main_losses}: rel gap {gap:.3g} > "
                             f"{LOSS_RTOL}")
    plan, tl = rt.trainer.transfer_plans()[0], rt.timeline()
    say("pipeline", f"losses {losses}; the main path's {main_losses}, "
                    f"rel gap {gap:.3g} (rtol {LOSS_RTOL}); {smi}")
    say("pipeline", f"boundary 0 plan {plan.decision}, speedup "
                    f"{plan.speedup:.4f} over the whole tensor; simulated "
                    f"makespan {tl.makespan:.3f} s, bubble fraction "
                    f"{tl.bubble_fraction:.4f} (tests/test_torch_pipeline"
                    f".py holds these to the reference's at this shape)")
    if profile:
        profile_step(rt, run["steady"], "pipeline")
    del rt, run
    free_cuda()
    pipeline_witness(arch, dev)


# ---------------------------------------------------------------------------
# phase 10: the MoE MLP (granite-moe-1b-a400m) under zero and pipeline
# ---------------------------------------------------------------------------


def moe_flash(arch, dev) -> dict:
    """Flash at the MoE paths' calls, before they run: GQA 16/8 at T =
    1024, B = 2 (the ZeRO step's; checked and timed, a record of its own)
    and B = 1 (the pipeline's micro-batch; checked)."""
    from repro_torch.kernels.flash_attention.ops import (_ref_fwd,
                                                         flash_attention)
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        rec = time_flash(gen, dev, arch, 0, "moe")
        q, k, v = _qkv(gen, dev, 1, arch.num_heads, arch.num_kv_heads,
                       MOE["seq"], arch.head_dim, torch.float32, True)
        err = (flash_attention(q, k, v, True, 0, 0.0)
               - _ref_fwd(q, k, v, True, 0, 0.0)).abs().max().item()
    if not err <= F32_ATOL:
        raise AssertionError(f"flash at the MoE pipeline's B = 1: max abs "
                             f"err {err:.3g} > {F32_ATOL}")
    say("moe", f"flash_attention_fwd at B = 1 (the pipeline's micro-batch),"
               f" H={arch.num_heads}/{arch.num_kv_heads}, T={MOE['seq']}: "
               f"max abs err {err:.3g} (atol {F32_ATOL})")
    rec["max_abs_err_b1"] = err
    return rec


def moe_zero(profile: bool, smi: str) -> dict:
    """STEPS ZeRO steps of full-width granite-moe-1b-a400m under the
    DynaComm plan (asserted against the port's own ``core``), launches,
    peak against the reckoning; then the same steps under the other three
    strategies, losses bitwise."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import (RuntimeConfig, ScheduleConfig,
                                     build_runtime)
    config = RuntimeConfig(**MOE, schedule=ScheduleConfig(
        strategy="dynacomm"))
    _, want, specs = main_plan_specs(MOE["arch"])
    check_replan_buckets(want, specs)
    say("moe", f"bucket_pack / bucket_unpack bitwise against their plain "
               f"versions at the plan's pull buckets "
               f"{sorted({len(b) for b in want.forward})} and push buckets "
               f"{sorted({len(b) for b in want.backward})} (layers)")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = build_runtime(config)
    torch.cuda.synchronize()
    arch, plan = rt.arch, rt.plan
    if sizes(plan) != sizes(want):
        raise AssertionError(f"moe: plan {sizes(plan)} != the port's core "
                             f"{sizes(want)}")
    say("moe", f"{arch.name}: {arch.num_layers} layers, d_model "
               f"{arch.d_model}, heads {arch.num_heads}/{arch.num_kv_heads} "
               f"x {arch.head_dim}, {arch.num_experts} experts of d_ff "
               f"{arch.d_ff}, top-{arch.top_k}, {arch.activation} gated "
               f"{arch.gated_mlp}, vocab {arch.vocab_size}; batch "
               f"{config.batch} x seq {config.seq}; built in "
               f"{time.perf_counter() - t0:.1f} s")
    say("moe", f"plan (dynacomm): {len(plan.forward)} pull buckets "
               f"{[len(b) for b in plan.forward]}, {len(plan.backward)} push "
               f"buckets {[len(b) for b in plan.backward]} == the port's "
               f"core")
    reset_launch_counts()
    losses, secs = timed_steps(rt, STEPS)
    counts = launch_counts()
    expect = expected_launches(plan, arch, ())
    if counts != expect:
        raise AssertionError(f"moe: launches {counts} != expected {expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"moe: non-finite losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    copy = sum(s.total * 4 for s in specs) / 2**30
    reckoned = MOE_COPIES * copy + MOE_ACTIVATION_GIB
    if not peak <= reckoned:
        raise AssertionError(f"moe: peak {peak:.2f} GiB > the reckoning "
                             f"{reckoned:.2f}")
    steady = sum(secs[1:]) / len(secs[1:])
    tokens = config.batch * config.seq
    say("moe", f"zero losses {losses}")
    say("moe", f"zero step seconds {[round(x, 4) for x in secs]}; steady "
               f"{steady * 1e3:.1f} ms/step (steps 2-{STEPS}), "
               f"{tokens / steady:.1f} tokens/s; peak {peak:.2f} GiB "
               f"against the reckoning {reckoned:.2f} ({MOE_COPIES} x "
               f"{copy:.3f} GiB + {MOE_ACTIVATION_GIB}); {smi}")
    say("moe", f"zero launches over {STEPS} steps {counts} == plan (flash "
               f"2 x {arch.num_layers} x {STEPS})")
    if profile:
        profile_step(rt, steady, "profile moe")
    del rt
    free_cuda()
    for strategy in MOE_STRATEGIES:
        rt = build_runtime(dataclasses.replace(
            config, schedule=ScheduleConfig(strategy=strategy)))
        got, other = rt.fit(STEPS), sizes(rt.plan)
        del rt
        free_cuda()
        if got != losses:
            raise AssertionError(f"moe: {strategy} losses {got} != "
                                 f"dynacomm's {losses}")
        say("moe", f"zero/{strategy}: plan {other}, losses bitwise "
                   f"dynacomm's")
    return counts


def moe_aux_witness(arch, dev, seq: int = MOE["seq"],
                    batch: int = MOE["batch"]) -> dict:
    """At MOE_AUX_LAYERS blocks of ``arch``: the ZeRO step's gradients (an
    optimizer that records them) against ``torch.autograd`` of
    ``train_loss`` on the same device and inputs, each leaf within
    GRAD_SCALE_RTOL of its own largest magnitude; then the router's
    gradient at ``aux_weight = 0`` moves by more than twice that.  Raises
    on a failure; returns the worst gap, block 1's router gap and its
    move.  The caller drops the process group the trainer made."""
    from repro_torch import tree
    from repro_torch.core import BucketPlan
    from repro_torch.data.pipeline import SyntheticText
    from repro_torch.dist.collectives import unflatten_tree
    from repro_torch.dist.zero import ZeroTrainer
    from repro_torch.models import (num_sched_layers, params_from_sched_layers,
                                    sched_layer_trees, train_loss)
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import Optimizer
    small = dataclasses.replace(arch, num_layers=MOE_AUX_LAYERS)
    Ls = num_sched_layers(small)
    plan = BucketPlan(forward=(tuple(range(Ls)),),
                      backward=(tuple(reversed(range(Ls))),))
    data = {k: v.to(dev) for k, v in SyntheticText(
        small.vocab_size, seq, batch, seed=0).batch(0).items()}

    def zero_grads(aux_weight):
        seen, base = [], adamw(3e-4)

        def update(grads, state, params):
            seen.extend(g.clone() for g in grads)
            return base.update(grads, state, params)
        tr = ZeroTrainer(cfg=small, plan=plan, device=dev,
                         optimizer=Optimizer(init=base.init, update=update),
                         aux_weight=aux_weight)
        state = tr.init_state(torch.Generator(device=dev).manual_seed(0))
        layers = [tree.tree_map(torch.clone, t) for t in
                  sched_layer_trees(tr.params_from_state(state))]
        tr.step(state, data)
        del state
        return tr.specs, layers, [unflatten_tree(g, spec)
                                  for g, spec in zip(seen, tr.specs)]

    _, layers, got = zero_grads(0.01)
    params = [tree.tree_map(lambda x: x.requires_grad_(), t) for t in layers]
    loss = train_loss(small, params_from_sched_layers(params), data,
                      aux_weight=0.01)
    want = list(torch.autograd.grad(
        loss, [x for t in params for x in tree.leaves(t)]))
    gaps = {}
    for l, g in enumerate(got):
        for path, leaf in tree.leaves_with_paths(g):
            gaps[l, path] = leaf_gap(leaf, want.pop(0))
            if not gaps[l, path] <= GRAD_SCALE_RTOL:
                raise AssertionError(f"moe aux witness: layer {l} {path}: "
                                     f"{gaps[l, path]:.3g} of the leaf's "
                                     f"scale from autograd's gradient")
    router = got[1]["moe"]["router"]
    _, _, got0 = zero_grads(0.0)
    moved = leaf_gap(router, got0[1]["moe"]["router"])
    if not moved > 2 * GRAD_SCALE_RTOL:
        raise AssertionError(f"moe aux witness: the router's gradient moved "
                             f"{moved:.3g} of its scale without the aux "
                             f"term: the term is not carried")
    del layers, params, got, got0, want
    return dict(worst=max(gaps.values()), moved=moved,
                router=gaps[1, ("moe", "router")])


def moe_pipeline(profile: bool, smi: str) -> None:
    """``pipeline`` at granite-moe's full width under ``pipeline.json``'s
    block (``run_pipeline_path``'s checks); losses against S = 1, M = 2
    (the aux and embedding grouping: roundoff); then gpipe against 1f1b
    bitwise at MOE_WITNESS_LAYERS blocks."""
    from repro_torch.data.pipeline import SyntheticText
    from repro_torch.optim import adamw
    from repro_torch.pipeline import PipelineTrainer
    from repro_torch.runtime import build_runtime
    config = pipeline_config(MOE["arch"])
    run = run_pipeline_path(config, MOE_PIPELINE_SEGMENTS, "moe")
    rt, losses = run["rt"], run["losses"]
    arch, dev = rt.arch, rt.trainer.device
    say("moe", f"pipeline losses {losses}; {smi}")
    if profile:
        profile_step(rt, run["steady"], "profile moe pipeline")
    del rt, run
    free_cuda()
    one = build_runtime(dataclasses.replace(config, pipeline=dataclasses
                                            .replace(config.pipeline,
                                                     stages=1)))
    ones = one.fit(STEPS)
    del one
    free_cuda()
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ones))
    if not gap <= LOSS_RTOL:
        raise AssertionError(f"moe pipeline: S = 2 {losses} vs S = 1 "
                             f"{ones}: rel gap {gap:.3g} > {LOSS_RTOL}")
    say("moe", f"pipeline S = 1, M = 2: {ones}; rel gap {gap:.3g} to S = 2 "
               f"(rtol {LOSS_RTOL}: the aux and tied-embedding sums group "
               f"by stage)")

    small = dataclasses.replace(arch, num_layers=MOE_WITNESS_LAYERS)
    data = SyntheticText(small.vocab_size, MOE["seq"], MOE["batch"], seed=0)

    def witness(name):
        ptr = PipelineTrainer(cfg=small, optimizer=adamw(3e-4), device=dev,
                              num_stages=2, num_microbatches=2,
                              schedule_name=name)
        state = ptr.init_state(torch.Generator(device=dev).manual_seed(0))
        out = []
        for i in range(2):
            state, loss = ptr.step(state, data.batch(i))
            out.append(float(loss))
        flats = [f.clone() for f in state["flat_params"]]
        del state, ptr
        free_cuda()
        return out, flats
    a, b = witness("1f1b"), witness("gpipe")
    if a[0] != b[0] or any(not torch.equal(bits(x), bits(y))
                           for x, y in zip(a[1], b[1])):
        raise AssertionError(f"moe pipeline witness: gpipe {b[0]} vs 1f1b "
                             f"{a[0]}")
    say("moe", f"pipeline witness at {MOE_WITNESS_LAYERS} blocks of full "
               f"width, 2 steps: gpipe and 1f1b losses and parameters "
               f"bitwise ({a[0]})")


def moe_card_against_cpu() -> None:
    """Reduced granite-moe with tokens dropping (MOE_DROPPING) under
    ``zero.json`` and ``pipeline.json``: the card against the port on the
    CPU from one initial state."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import RuntimeConfig
    model = dataclasses.replace(get_config(MOE["arch"]).reduced(),
                                **MOE_DROPPING)
    cfgs = ROOT / "examples" / "runtime_configs"
    for name in ("zero", "pipeline"):
        gap, card, cpu = card_against_cpu(
            RuntimeConfig.load(str(cfgs / f"{name}.json")), model)
        if not gap <= CARD_CPU_RTOL:
            raise AssertionError(f"moe {name}.json: card {card} vs CPU "
                                 f"{cpu}: rel gap {gap:.3g} > "
                                 f"{CARD_CPU_RTOL}")
        say("moe", f"reduced MoE ({MOE_DROPPING}) under {name}.json from "
                   f"one initial state: card {card}, CPU {cpu}; rel gap "
                   f"{gap:.3g} (rtol {CARD_CPU_RTOL})")
    drop_group()


def phase_moe(profile: bool, smi: str) -> tuple:
    """The MoE MLP at granite-moe-1b-a400m's full width: flash at its
    shapes, ``zero`` (3 steps, four strategies), the aux witness,
    ``pipeline`` and card against CPU.  Returns the flash record and the
    ZeRO path's launches."""
    from repro_torch.configs import get_config
    arch = get_config(MOE["arch"])
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rec = moe_flash(arch, dev)
    free_cuda()
    counts = moe_zero(profile, smi)
    w = moe_aux_witness(arch, dev)
    drop_group()
    free_cuda()
    say("moe", f"aux witness at {MOE_AUX_LAYERS} blocks of full width: the "
               f"ZeRO step's gradients (the block pull-back with (ct, "
               f"0.01)) within {w['worst']:.3g} of each leaf's largest "
               f"magnitude of autograd's train_loss gradient (rtol "
               f"{GRAD_SCALE_RTOL}), block 1's router {w['router']:.3g}; "
               f"at aux_weight 0 block 1's router "
               f"gradient moves {w['moved']:.3g} of its scale")
    moe_pipeline(profile, smi)
    moe_card_against_cpu()
    say("moe", f"phase {time.perf_counter() - t0:.1f} s; {smi}")
    return rec, counts


def phase_mla(smi: str) -> int:
    """STEPS ZeRO steps of Moonlight-16B-A3B cut to MLA_LAYERS layers of
    d_model MLA_D_MODEL (the dense layer 0, then MoE layers), its latent
    attention at the published widths, under the DynaComm plan: every
    kernel's launches as the plan says, and every flash launch the
    template of a narrower v.  Returns that template's launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.runtime import (RuntimeConfig, ScheduleConfig,
                                     build_runtime)
    full = get_config(MLA["arch"])
    widths = {k: getattr(full, k) for k in (
        "num_heads", "num_kv_heads", "head_dim", "kv_lora_rank",
        "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim")}
    arch = dataclasses.replace(full.reduced(
        num_layers=MLA_LAYERS, d_model=MLA_D_MODEL, vocab=MLA_VOCAB),
        **widths)
    config = RuntimeConfig(**MLA, schedule=ScheduleConfig(
        strategy="dynacomm"))
    free_cuda()
    rt = build_runtime(config, arch)
    reset_launch_counts()
    losses, secs = timed_steps(rt, STEPS)
    counts = launch_counts()
    narrow = ops.NARROW_V_LAUNCHES["flash_attention_fwd@mla"]
    expect = expected_launches(rt.plan, arch, ())
    if counts != expect:
        raise AssertionError(f"mla: launches {counts} != expected {expect}")
    if narrow != counts["flash_attention_fwd"] \
            or narrow != 2 * MLA_LAYERS * STEPS:
        raise AssertionError(f"mla: {narrow} launches of the narrow-v "
                             f"template of {counts['flash_attention_fwd']} "
                             f"flash launches, not 2 x {MLA_LAYERS} x "
                             f"{STEPS}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mla: non-finite losses {losses}")
    say("mla", f"{arch.num_layers} layers {arch.mlp_kinds()}, d_model "
               f"{arch.d_model}, MLA {arch.num_heads} heads of q / k "
               f"{arch.head_dim} and v {arch.v_head_dim} over a latent of "
               f"{arch.kv_lora_rank}; batch {config.batch} x seq "
               f"{config.seq}; losses {losses}; step seconds "
               f"{[round(x, 4) for x in secs]}; launches over {STEPS} steps "
               f"{counts} == plan, all {narrow} flash launches the 192 / "
               f"128 template's; {smi}")
    del rt
    drop_group()
    free_cuda()
    return narrow


# ---------------------------------------------------------------------------
# phase 11: the last model families (xLSTM and the audio frontend)
# ---------------------------------------------------------------------------


def mlstm_forms_on_the_card(dev) -> float:
    """The mLSTM's parallel form against its chunkwise form (chunk 64: 4
    chunks) at the full-width block's (B, H, T, hd) = (2, 4, 256, 512),
    within the reference's own bound for the claim."""
    from repro_torch.models import ssm
    gen = torch.Generator(device=dev).manual_seed(5)
    b, h, t, hd = MLSTM_FORMS_SHAPE
    q, k, v = (torch.randn(b, h, t, hd, generator=gen, device=dev)
               for _ in range(3))
    ig = torch.randn(b, h, t, generator=gen, device=dev)
    fg = torch.randn(b, h, t, generator=gen, device=dev) + 2.0
    with torch.no_grad():
        par = ssm._mlstm_parallel(q, k, v, ig, fg)
        chunked, _ = ssm._mlstm_chunkwise(q, k, v, ig, fg, chunk=64)
    err = (par - chunked).abs().max().item()
    if not err <= MLSTM_FORMS_ATOL:
        raise AssertionError(f"mLSTM parallel vs chunkwise on the card: max "
                             f"abs err {err:.3g} > {MLSTM_FORMS_ATOL}")
    say("families", f"mLSTM parallel form against the chunkwise form "
                    f"(chunk 64) at {MLSTM_FORMS_SHAPE}: max abs err "
                    f"{err:.3g} (atol {MLSTM_FORMS_ATOL}, the reference's "
                    f"claim) on values up to {par.abs().max().item():.3g}")
    return err


def slstm_share(rt, steady: float) -> None:
    """One more ZeRO step, untraced, with the host clock around each sLSTM
    block's forward (outside autograd) and each sLSTM block's pull-back
    (``models/model.py::layer_vjp``: the recompute under autograd and the
    backward), the card synchronised at each edge: their seconds against
    the step's.  The loop is host-paced (the trace's device time is a
    small part of the step), so its wall time is what the step pays."""
    from repro_torch.models import blocks
    from repro_torch.models import model as model_lib
    init, apply = blocks.RECURRENT["slstm"]
    vjp = model_lib.layer_vjp
    spent = {"forward": [], "pull-back": []}

    def clocked(kind, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spent[kind].append(time.perf_counter() - t0)
        return out

    def timed_apply(*a, **k):
        if torch.is_grad_enabled():           # the recompute in the VJP
            return apply(*a, **k)
        return clocked("forward", apply, *a, **k)

    def timed_vjp(fn, primals, cotangent):
        if isinstance(primals[0], dict) and "slstm" in primals[0]:
            return clocked("pull-back", vjp, fn, primals, cotangent)
        return vjp(fn, primals, cotangent)
    blocks.RECURRENT["slstm"] = (init, timed_apply)
    model_lib.layer_vjp = timed_vjp
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.fit(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        blocks.RECURRENT["slstm"] = (init, apply)
        model_lib.layer_vjp = vjp
    total = sum(map(sum, spent.values()))
    parts = ", ".join(f"{kind} {len(v)}x {sum(v):.3f} s"
                      for kind, v in spent.items())
    say("profile xlstm", f"sLSTM blocks ({parts}): {total:.3f} s of the "
                         f"step's {wall:.3f} s = {100 * total / wall:.1f}% "
                         f"(untraced steady step {steady * 1e3:.1f} ms)")


def family_zero(name: str, profile: bool, smi: str) -> tuple:
    """STEPS ZeRO steps of ``name`` at full width under the DynaComm plan
    (asserted against the port's own ``core`` and the host-only plan),
    launches against the plan, seconds a step and peak against the
    reckoning; then the other three strategies, losses and parameters
    bitwise.  Returns (launches, losses, steady seconds)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import (RuntimeConfig, ScheduleConfig,
                                     build_runtime)
    config = RuntimeConfig(**dict(MAIN, arch=name),
                           schedule=ScheduleConfig(strategy="dynacomm"))
    _, want, specs = main_plan_specs(name)
    if sizes(want) != FAMILY_PLANS[name]:
        raise AssertionError(f"{name}: the port's core plans {sizes(want)}, "
                             f"the reference's {FAMILY_PLANS[name]}")
    check_replan_buckets(want, specs)
    drop_group()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = build_runtime(config)          # batches: data.pipeline.batch_for
    torch.cuda.synchronize()
    arch, plan = rt.arch, rt.plan
    if sizes(plan) != sizes(want):
        raise AssertionError(f"{name}: plan {sizes(plan)} != the port's "
                             f"core {sizes(want)}")
    kinds = arch.layer_kinds()
    say("families", f"{arch.name}: {arch.num_layers} layers "
                    f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }, "
                    f"d_model {arch.d_model}, heads {arch.num_heads}, "
                    f"frontend {arch.frontend}, causal {arch.causal}, tied "
                    f"head {arch.tie_embeddings}, vocab {arch.vocab_size}, "
                    f"{sum(s.total for s in specs) / 1e9:.3f} B parameters; "
                    f"batch {config.batch} x seq {config.seq}; built in "
                    f"{time.perf_counter() - t0:.1f} s")
    say("families", f"{name} plan (dynacomm): {sizes(plan)} == the port's "
                    f"core == the reference's")
    reset_launch_counts()
    losses, secs = timed_steps(rt, STEPS)
    counts = launch_counts()
    expect = expected_launches(plan, arch, ())
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != expected "
                             f"{expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    copy = sum(s.total * 4 for s in specs) / 2**30
    reckoned = FAMILY_COPIES * copy + FAMILY_ACTIVATION_GIB
    if not peak <= reckoned:
        raise AssertionError(f"{name}: peak {peak:.2f} GiB > the reckoning "
                             f"{reckoned:.2f}")
    steady = sum(secs[1:]) / len(secs[1:])
    tokens = config.batch * config.seq
    say("families", f"{name} zero losses {losses}")
    say("families", f"{name} zero step seconds "
                    f"{[round(x, 4) for x in secs]}; steady "
                    f"{steady * 1e3:.1f} ms/step (steps 2-{STEPS}), "
                    f"{tokens / steady:.1f} tokens/s; peak {peak:.2f} GiB "
                    f"against the reckoning {reckoned:.2f} ({FAMILY_COPIES} "
                    f"x {copy:.3f} GiB + {FAMILY_ACTIVATION_GIB}); {smi}")
    say("families", f"{name} zero launches over {STEPS} steps {counts} == "
                    f"the plan's")
    # the parameters after the steps, beside the losses: hubert's stub
    # labels are all 0, so its loss reaches 0.0 and says little after step 1
    flats = [f.to("cpu", copy=True) for f in rt._state["flat_params"]]
    if profile:
        profile_step(rt, steady, f"profile {name}")
        if "slstm" in kinds:
            slstm_share(rt, steady)
    del rt
    free_cuda()
    for strategy in FAMILY_STRATEGIES:
        rt = build_runtime(dataclasses.replace(
            config, schedule=ScheduleConfig(strategy=strategy)))
        got, other = rt.fit(STEPS), sizes(rt.plan)
        same = all(torch.equal(bits(a.cpu()), bits(b)) for a, b in
                   zip(rt._state["flat_params"], flats))
        del rt
        free_cuda()
        if got != losses or not same:
            raise AssertionError(f"{name}: {strategy} losses {got} (dynacomm "
                                 f"{losses}), parameters bitwise {same}")
        say("families", f"{name} zero/{strategy}: plan {other}, losses and "
                        f"parameters bitwise dynacomm's")
    drop_group()
    return counts, losses, steady


def xlstm_pipeline(profile: bool, smi: str) -> None:
    """``pipeline`` at xlstm-350m's full width under ``pipeline.json``'s
    block (``run_pipeline_path``'s checks: the partition, no kernel of
    csrc/ and no collective, the ledger, peak); losses against S = 1, M =
    2 over the steps whose parameters differ by at most one update from
    roundoff-different gradients (the tied embedding's grouping: the first
    bitwise, the second to LOSS_RTOL; the third printed: the xLSTM's
    trajectories part there, ``tests/test_torch_xlstm.py``'s float64
    witness); then S = 1 against S = 2 at M = 1, bitwise, at
    XLSTM_WITNESS_LAYERS layers of full width."""
    from repro_torch.runtime import build_runtime
    config = pipeline_config(XLSTM["arch"])
    run = run_pipeline_path(config, XLSTM_PIPELINE_SEGMENTS, "families")
    rt, losses = run["rt"], run["losses"]
    say("families", f"xlstm pipeline losses {losses}; {smi}")
    if profile:
        profile_step(rt, run["steady"], "profile xlstm pipeline")
    del rt, run
    free_cuda()

    def stages(S, M, model=None):
        rt = build_runtime(dataclasses.replace(
            config, pipeline=dataclasses.replace(
                config.pipeline, stages=S, microbatches=M)), model)
        out = rt.fit(STEPS)
        del rt
        free_cuda()
        return out
    ones = stages(1, 2)
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ones)]
    if ones[0] != losses[0] or not gaps[1] <= LOSS_RTOL:
        raise AssertionError(f"xlstm pipeline: S = 2 {losses} vs S = 1 "
                             f"{ones}: rel gaps {gaps}")
    say("families", f"xlstm pipeline S = 1, M = 2: {ones}; step 1 bitwise, "
                    f"step 2 rel gap {gaps[1]:.3g} (rtol {LOSS_RTOL}), step "
                    f"3 {gaps[2]:.3g} (not asserted: the trajectories part)")
    small = dataclasses.replace(arch_of(config),
                                num_layers=XLSTM_WITNESS_LAYERS)
    one, two = stages(1, 1, small), stages(2, 1, small)
    if one != two:
        raise AssertionError(f"xlstm pipeline witness: S = 1 {one} vs S = "
                             f"2 {two} at M = 1")
    say("families", f"xlstm pipeline witness at {XLSTM_WITNESS_LAYERS} "
                    f"layers of full width, M = 1: S = 1 and S = 2 losses "
                    f"bitwise over {STEPS} steps ({one})")


def xlstm_witness() -> None:
    """XLSTM_WITNESS_LAYERS layers of xlstm-350m at full width (7 mLSTM, 1
    sLSTM; T = 1024: the chunkwise form) under ``zero`` with SGD, on the
    card against the port on the CPU from one initial state: the losses of
    2 steps to LOSS_RTOL, and every parameter leaf after the first step
    within XLSTM_WITNESS_RTOL of its largest magnitude.  SGD keeps the
    update linear in the gradient (AdamW's first step is sign-like: a
    roundoff-level gradient entry moves by ±lr either way); past the
    second loss the xLSTM's trajectories part at roundoff (the float64
    witness of ``tests/test_torch_xlstm.py``)."""
    import tempfile
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.runtime import RuntimeConfig, build_runtime
    model = dataclasses.replace(get_config(XLSTM["arch"]),
                                num_layers=XLSTM_WITNESS_LAYERS)
    config = RuntimeConfig(**dict(XLSTM, optimizer="sgd", lr=WITNESS_LR))
    runs = {}
    (ROOT / "build").mkdir(exist_ok=True)               # ignored by git
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "init.npz")
        for device in ("cpu", None):
            drop_group()
            t0 = time.perf_counter()
            rt = build_runtime(config, model, device=device)
            if device == "cpu":
                rt.save_state(path)
            else:
                rt.restore_state(path)
            losses = rt.fit(1)
            params = tree.tree_map(        # a copy: the state updates in place
                lambda x: x.detach().to("cpu", copy=True),
                rt.trainer.params_from_state(rt._state))
            losses += rt.fit(1)
            runs[device] = (losses, params, time.perf_counter() - t0)
            del rt
            drop_group()
            free_cuda()
    (cpu, cpu_p, cpu_s), (card, card_p, card_s) = runs["cpu"], runs[None]
    gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    leaves = [(p, leaf_gap(a, b)) for (p, a), b in zip(
        tree.leaves_with_paths(card_p), tree.leaves(cpu_p))]
    worst = max(leaves, key=lambda x: x[1])
    if not gap <= LOSS_RTOL or not worst[1] <= XLSTM_WITNESS_RTOL:
        raise AssertionError(f"xlstm witness: card {card} vs CPU {cpu} (rel "
                             f"gap {gap:.3g}), worst leaf {worst}")
    say("families", f"xlstm witness at {XLSTM_WITNESS_LAYERS} layers of full "
                    f"width, T = {XLSTM['seq']}, SGD (lr {WITNESS_LR}): 2 "
                    f"losses card {card}, CPU {cpu}, rel gap {gap:.3g} (rtol "
                    f"{LOSS_RTOL}); {len(leaves)} parameter leaves after "
                    f"step 1, worst {worst[0]} {worst[1]:.3g} of its largest "
                    f"magnitude (limit {XLSTM_WITNESS_RTOL}); CPU "
                    f"{cpu_s:.1f} s, card {card_s:.1f} s")


def phase_families(profile: bool, smi: str) -> tuple:
    """xlstm-350m and hubert-xlarge at their published widths: the mLSTM's
    two forms on the card, xLSTM ``zero`` (four strategies) and
    ``pipeline``, the 8-layer witness against the CPU; flash at hubert's
    shape (hd 80, non-causal: the HD = 128 template), hubert ``zero``
    (four strategies).  Returns the flash record and each path's ZeRO
    launches."""
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    mlstm_forms_on_the_card(dev)
    xlstm_counts, _, _ = family_zero(XLSTM["arch"], profile, smi)
    xlstm_pipeline(profile, smi)
    xlstm_witness()
    hubert = get_config(HUBERT["arch"])
    with torch.no_grad():
        rec = time_flash(torch.Generator(device=dev).manual_seed(4), dev,
                         hubert, 0, "hubert", causal=hubert.causal)
    free_cuda()
    hubert_counts, _, _ = family_zero(HUBERT["arch"], profile, smi)
    say("families", f"phase {time.perf_counter() - t0:.1f} s; {smi}")
    return rec, {"xlstm": xlstm_counts, "hubert": hubert_counts}


# ---------------------------------------------------------------------------
# phase 12: serving at full width
# ---------------------------------------------------------------------------


def reckon_cache_bytes(cfg, b: int, prompt: int, tokens: int) -> dict:
    """The caches a prefill of ``prompt`` leaves for ``tokens`` decode
    steps, by the formula: a global layer's K and V at ``prompt + tokens``
    slots, a local layer's at its window, each attention cache's int32
    ``pos``; the recurrences' states in float32."""
    kv_slot = 2 * b * cfg.num_kv_heads * cfg.head_dim * 4
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    hd = di // cfg.num_heads if cfg.num_heads else 0
    w = cfg.rglru_lru_width or cfg.d_model
    out = {"kv": 0, "pos": 0, "state": 0}
    for kind in cfg.layer_kinds():
        if kind == "global_attn":
            out["kv"] += kv_slot * (prompt + tokens)
        elif kind == "local_attn":
            out["kv"] += kv_slot * cfg.sliding_window
        elif kind == "mlstm":
            out["state"] += 4 * b * cfg.num_heads * (hd * hd + hd + 1)
        elif kind == "slstm":
            out["state"] += 4 * 4 * b * cfg.d_model
        elif kind == "rglru":
            out["state"] += 4 * b * w * (1 + 3)
        out["pos"] += 4 if kind in ("global_attn", "local_attn") else 0
    return out


def flash_at_the_prefill_shapes(dev) -> dict:
    """Flash against its plain version at each served model's prefill
    shape (atol 2e-6, f32, the model's (B, T, H, hd) views), then timed at
    the main served path's as the record ``flash_attention_fwd@serve``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (_ref_fwd,
                                                         flash_attention)
    gen = torch.Generator(device=dev).manual_seed(6)
    with torch.no_grad():
        for name in ("recurrentgemma-2b", "granite-moe-1b-a400m"):
            cfg = get_config(name)
            b, t, _ = SERVE[name]
            q, k, v = _qkv(gen, dev, b, cfg.num_heads, cfg.num_kv_heads, t,
                           cfg.head_dim, torch.float32, True)
            err = (flash_attention(q, k, v, True, cfg.sliding_window, 0.0)
                   - _ref_fwd(q, k, v, True, cfg.sliding_window, 0.0)
                   ).abs().max().item()
            if not err <= F32_ATOL:
                raise AssertionError(f"flash at {name}'s prefill: max abs "
                                     f"err {err:.3g} > {F32_ATOL}")
            say("serve", f"flash_attention_fwd at {name}'s prefill (B={b}, "
                         f"H={cfg.num_heads}/{cfg.num_kv_heads}, T={t}, "
                         f"hd={cfg.head_dim}, window {cfg.sliding_window})"
                         f" f32: max abs err {err:.3g} (atol {F32_ATOL})")
            del q, k, v
            free_cuda()
        name = "granite-3-2b"
        b, t, _ = SERVE[name]
        return time_flash(gen, dev, get_config(name), 0, "serve", b=b, t=t)


def scan_at_the_prefill_shape(dev) -> dict:
    """``rglru_scan`` bitwise against its plain loop at recurrentgemma's
    prefill (B, T, W) = (2, 2100, 2560) f32, then timed: the record
    ``rglru_scan@serve``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan import ops, ref
    cfg = get_config("recurrentgemma-2b")
    b, t, _ = SERVE[cfg.name]
    gen = torch.Generator(device=dev).manual_seed(7)
    a, x = _scan_inputs(gen, dev, b, t, cfg.rglru_lru_width, torch.float32)
    assert_bitwise(ops.scan(a, x), ref.rglru_scan_ref(a, x),
                   "rglru_scan at the served prefill's shape")
    warm_up(lambda: ops.scan(a, x))
    rec = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: ops.scan(a, x), 20),
               plain_ms=cuda_ms(lambda: ref.rglru_scan_ref(a, x), 3,
                                ahead=False),
               library_ms=None,
               bound_ms=3 * 4 * a.numel() / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    say("serve", f"rglru_scan at the served prefill's (B={b}, T={t}, "
                 f"W={cfg.rglru_lru_width}) f32: bitwise the plain loop; "
                 f"{rec['ms']:.4f} ms = {100 * rec['bound_ms'] / rec['ms']:.1f}"
                 f"% of its byte bound {rec['bound_ms']:.4f} (plain "
                 f"{rec['plain_ms']:.4f})")
    return rec


def serve_through_the_launcher(name: str, smi: str, shape=None,
                               phase: str = "serve") -> tuple:
    """``repro_torch.launch.serve`` on ``name`` at full width, greedy: the
    kernels' launches counted after the prefill and after the decode (none
    may come from the decode but an MoE's routing), the cache bytes
    against the reckoning, prefill ms, decode ms a token, tokens/s and
    peak.  Then the
    full-forward check: one ``forward`` over prompt + served tokens gives
    every decoded position's logits within the stated bound, and its
    greedy token wherever its top-2 margin exceeds twice that bound (MoE at
    capacity factor E / k: no token can drop).  Returns the prefill's
    launches and the run.  ``shape`` = (requests, prompt, tokens) is
    ``SERVE[name]``'s unless given; ``phase`` tags the lines.  An MoE
    routes every decoded token on the card: its position kernel is the one
    kernel the decode may launch (once a block in each step that runs
    eagerly or captures; a replayed graph launches through the graph)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model
    from repro_torch.serve import batched_generate
    b, p, k = shape or SERVE[name]
    logits, counts = [], {}

    def on_step(i, step_logits, caches):
        logits.append(step_logits[:, -1].float().clone())
        if i == 0:
            counts.update(launch_counts())
    reset_launch_counts()
    run = launcher.main(["--arch", name, "--requests", str(b),
                         "--prompt-len", str(p), "--tokens", str(k),
                         "--greedy"], on_step=on_step)
    after = launch_counts()
    cfg = run["cfg"]
    kinds = cfg.layer_kinds()
    want = {"flash_attention_fwd": sum(x.endswith("attn") for x in kinds),
            "rglru_scan": kinds.count("rglru"),
            "moe_positions": len(kinds) if cfg.is_moe else 0}
    for kernel, n in after.items():
        if counts[kernel] != want.get(kernel, 0):
            raise AssertionError(f"{name} prefill: {kernel} launched "
                                 f"{counts[kernel]} times, expected "
                                 f"{want.get(kernel, 0)}")
        if kernel == "moe_positions" and cfg.is_moe:
            if (n - counts[kernel]) % len(kinds):
                raise AssertionError(f"{name} decode launched {kernel} "
                                     f"{n - counts[kernel]} times, not a "
                                     f"whole number of steps")
        elif n != counts[kernel]:
            raise AssertionError(f"{name} decode launched {kernel} "
                                 f"{n - counts[kernel]} times")
    prefill_launches = {x: counts[x] for x in want}
    reckon = reckon_cache_bytes(cfg, b, p, k)
    if run["cache_bytes"] != sum(reckon.values()):
        raise AssertionError(f"{name}: caches {run['cache_bytes']} B "
                             f"against the reckoning {reckon}")
    peak = run["peak_bytes"] / 2**30
    say(phase, f"{name} through the launcher ({b} x {p} -> {k} tokens, "
               f"greedy): prefill {run['prefill_ms']:.1f} ms, decode "
               f"{run['decode_ms_steady']:.2f} ms a token steady "
               f"({run['decode_ms']:.2f} with the first), "
               f"{run['tokens_per_s']:.1f} tokens/s ({b * k} tokens in "
               f"{run['seconds']:.3f} s), peak {peak:.2f} GiB; caches "
               f"{run['cache_bytes']:,} B = the reckoning (KV "
               f"{reckon['kv']:,}, states {reckon['state']:,}, pos "
               f"{reckon['pos']}); prefill launches {prefill_launches}, "
               f"{'only the routing' if cfg.is_moe else 'none'} in decode; "
               f"{smi}")

    check, tokens = cfg, run["tokens"]
    if cfg.is_moe:
        # the timed prefill (N = B·P tokens at the config's capacity
        # factor) may drop tokens that a forward over B·(P + K) keeps: the
        # check serves again at E / k, where C = N and none can drop
        check = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                    / cfg.top_k)
        logits.clear()
        tokens = batched_generate(
            check, run["params"], run["prompts"], max_new_tokens=k,
            on_step=lambda i, lg, c: logits.append(lg[:, -1].float()
                                                   .clone()))
        say(phase, f"{name} served again at capacity factor "
                   f"{check.capacity_factor:g} for the check: "
                   f"{int((tokens == run['tokens']).sum())} of {b * k} "
                   f"tokens equal the timed run's")
    seq = torch.cat([run["prompts"], tokens], dim=1)
    with torch.inference_mode():
        full, _, _ = model.forward(check, run["params"], {"tokens": seq})
    full = full[:, p - 1:].float()                  # (B, K + 1, V)
    got = torch.stack(logits, dim=1)
    gap = (got - full).abs().max().item()
    bound = SERVE_FULL_ATOL
    if cfg.family == "ssm":
        bound = SERVE_XLSTM_RTOL * full.abs().max().item()
    top2 = full[:, :k].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * bound
    same = full[:, :k].argmax(-1) == tokens.long()
    if not gap <= bound or not bool(same[clear].all()):
        raise AssertionError(f"{name}: decode against the full forward: "
                             f"worst gap {gap:.3g} (bound {bound:.3g}); "
                             f"tokens equal {int(same[clear].sum())} of "
                             f"{int(clear.sum())} clear")
    say(phase, f"{name} full-forward check over {p + k} positions"
               f"{' (capacity factor E/k)' if cfg.is_moe else ''}: decode "
               f"logits within {gap:.3g} (bound {bound:.3g}), greedy tokens "
               f"equal at {int(clear.sum())} of {b * k} positions clear of "
               f"a tie")
    del full, got, logits, tokens
    decode_trace(run, phase=phase)
    return prefill_launches, run


def decode_trace(run, steps: int = 3, phase: str = "serve") -> None:
    """``steps`` eager decode steps of the served model under
    ``torch.profiler`` (after a fresh prefill and one untraced step):
    kernels a step, device busy ms a step against the served run's steady
    decode ms, a replayed CUDA graph of the same kernels (the idle share),
    and the five largest kernels."""
    from repro_torch.models import model
    from repro_torch.serve import decode as serve
    cfg, params, prompts = run["cfg"], run["params"], run["prompts"]
    with torch.inference_mode():
        logits, caches = serve.prefill(cfg, params, {"tokens": prompts},
                                       max_len=prompts.shape[1] + steps + 1)
        state = {"tok": logits[:, -1].argmax(-1)[:, None].to(torch.int32),
                 "caches": caches}

        def step():
            logits, state["caches"] = model.decode_step(
                cfg, params, state["tok"], state["caches"])
            state["tok"] = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        step()
        rows = traced(lambda: [step() for _ in range(steps)])
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    launches = sum(e.count for e in rows) / steps
    steady = run["decode_ms_steady"]
    rows.sort(key=lambda e: -e.self_device_time_total)
    top = "; ".join(f"{e.self_device_time_total / 1e3 / steps:.2f} ms "
                    f"{e.count // steps}x {e.key[:40]}" for e in rows[:5])
    say(phase, f"{cfg.name} decode traced ({steps} steps): {launches:.0f} "
               f"kernels a step, device busy {busy:.2f} ms a step = "
               f"{100 * busy / steady:.1f}% of the served steady "
               f"{steady:.2f} ms (idle {100 * max(0.0, 1 - busy / steady):.1f}"
               f"%); largest: {top}")


def slstm_prefill_share(run) -> None:
    """The served xLSTM's prefill again, the card synchronised at each
    sLSTM block's edges: their host seconds against the prefill's (the
    loop is host-paced)."""
    from repro_torch.models import blocks
    from repro_torch.serve import decode as serve
    init, apply = blocks.RECURRENT["slstm"]
    spent = []

    def clocked(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out
    blocks.RECURRENT["slstm"] = (init, clocked)
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve.prefill(run["cfg"], run["params"],
                          {"tokens": run["prompts"]})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        blocks.RECURRENT["slstm"] = (init, apply)
    say("serve", f"xlstm-350m prefill again with the sLSTM blocks clocked: "
                 f"{len(spent)} blocks {sum(spent):.3f} s of "
                 f"{wall:.3f} s = {100 * sum(spent) / wall:.1f}% (the served"
                 f" prefill took {run['prefill_ms']:.1f} ms)")


def serve_card_against_cpu(name: str, prompt: int, total: int,
                           dev) -> float:
    """Reduced ``name`` served greedily on the card and by the port on the
    CPU from one initial state (the CPU's parameters copied over): logits
    at every step within ``SERVE_CARD_CPU_ATOL``, tokens wherever the CPU's
    top-2 margin exceeds twice it.  Returns the worst logit gap."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import batched_generate
    import numpy as np
    cfg = get_config(name).reduced(
        num_layers=3 if name == "recurrentgemma-2b" else 2)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, prompt), dtype=np.int32))
    runs = []
    for device in ("cpu", dev):
        logits = []
        out = batched_generate(
            cfg, tree.tree_map(lambda x: x.to(device), params),
            prompts.to(device), max_new_tokens=total - prompt,
            on_step=lambda i, lg, c: logits.append(lg[:, -1].cpu()))
        runs.append((out.cpu(), torch.stack(logits, dim=1)))
    (cpu_out, cpu_logits), (card_out, card_logits) = runs
    gap = (card_logits - cpu_logits).abs().max().item()
    top2 = cpu_logits[:, :-1].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * SERVE_CARD_CPU_ATOL
    if not gap <= SERVE_CARD_CPU_ATOL or \
            not torch.equal(card_out[clear], cpu_out[clear]):
        raise AssertionError(f"reduced {name} served on the card against "
                             f"the CPU: logit gap {gap:.3g} (atol "
                             f"{SERVE_CARD_CPU_ATOL}) or tokens differ")
    return gap


def phase_serve(smi: str) -> tuple:
    """Serving at full width through ``repro_torch.launch.serve``:
    granite-3-2b (the main served path), recurrentgemma-2b past its
    window, xlstm-350m and granite-moe-1b-a400m; flash and the scan at the
    prefill shapes; reduced serving on the card against the CPU.  Returns
    the two records and their launches."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    records = {"flash_attention_fwd@serve": flash_at_the_prefill_shapes(dev),
               "rglru_scan@serve": scan_at_the_prefill_shape(dev)}
    free_cuda()
    counts = {}
    for name in SERVE:
        launches, run = serve_through_the_launcher(name, smi)
        if name == "granite-3-2b":
            counts["flash_attention_fwd@serve"] = \
                launches["flash_attention_fwd"]
        if name == "recurrentgemma-2b":
            counts["rglru_scan@serve"] = launches["rglru_scan"]
        if name == "xlstm-350m":
            slstm_prefill_share(run)
        del run
        free_cuda()
    for name, prompt, total in SERVE_CARD_CPU:
        gap = serve_card_against_cpu(name, prompt, total, dev)
        say("serve", f"reduced {name} (P = {prompt}, T = {total}) served on "
                     f"the card and on the CPU from one initial state: "
                     f"logits within {gap:.3g} (atol {SERVE_CARD_CPU_ATOL}),"
                     f" tokens equal")
    say("serve", f"phase {time.perf_counter() - t0:.1f} s; {smi}")
    return records, counts


# ---------------------------------------------------------------------------
# phase 13: the verification layer on the card
# ---------------------------------------------------------------------------


def arch_of(config):
    """The ``ArchConfig`` a runtime config names (``build_runtime``'s)."""
    from repro_torch.configs import get_config
    arch = get_config(config.arch)
    return arch.reduced() if config.reduced else arch


def flat_specs(arch) -> list:
    """``arch``'s world-1 FlatSpecs, from its shapes on the host."""
    from repro_torch.dist.collectives import make_flat_spec
    from repro_torch.models import param_shapes, sched_layer_trees
    return [make_flat_spec(t, 1)
            for t in sched_layer_trees(param_shapes(arch))]


def as_plan(obj):
    from repro_torch.core import BucketPlan
    return BucketPlan(forward=tuple(tuple(b) for b in obj["forward"]),
                      backward=tuple(tuple(b) for b in obj["backward"]))


def verified(tag: str, config) -> tuple:
    """``verify_runtime(config)`` on the card, its kernels' launches
    counted; any finding raises.  Returns (info, launches)."""
    from repro_torch.analysis.runtime_verify import verify_runtime
    from repro_torch.kernels import launch_counts, reset_launch_counts
    free_cuda()
    reset_launch_counts()
    t0 = time.perf_counter()
    findings, info = verify_runtime(config)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    if findings:
        raise AssertionError(f"verify {tag}: " + "; ".join(
            f.format() for f in findings))
    windows = {w: [k for k, _ in r] for w, r in info["collectives"].items()}
    say("verify", f"{tag}: no finding ({', '.join(info['checked'])}) in "
                  f"{secs:.1f} s; recorded {windows}")
    return info, counts


def held_to_the_plan(tag: str, records, plan, specs) -> None:
    """A recorded step's collectives against its plan's FlatSpec math, in
    order: one all-gather a forward bucket, one reduce-scatter a backward
    bucket, each with exactly the operand bytes."""
    from repro_torch.analysis import conformance
    want = [["all-gather", b]
            for b in conformance.expected_ag_bytes(specs, plan)] + \
        [["reduce-scatter", b]
         for b in conformance.expected_rs_bytes(specs, plan)]
    if records != want:
        raise AssertionError(f"verify {tag}: recorded {records} != the "
                             f"FlatSpec math {want}")
    ag = [b for k, b in records if k == "all-gather"]
    rs = [b for k, b in records if k == "reduce-scatter"]
    say("verify", f"{tag}: {len(ag)} all-gathers {ag} B (buckets "
                  f"{[len(b) for b in plan.forward]}) and {len(rs)} "
                  f"reduce-scatters {rs} B (buckets "
                  f"{[len(b) for b in plan.backward]}) == the FlatSpec "
                  f"math")


def phase_verify(smi: str) -> None:
    """``verify_runtime`` on the card: full-width granite-3-2b under
    ``zero``, ``ps`` (int8 and top-k pushes), ``dynamic`` and ``pipeline``,
    then the ten smoke configs, each with no finding; the recorded steps'
    collectives against the FlatSpec math and their kernels' launches
    against the plan; then one mutation that must be flagged."""
    from repro_torch.analysis import CollectiveRecord, verify_schedule
    from repro_torch.core import BucketPlan
    from repro_torch.runtime import (CompressionConfig, RuntimeConfig,
                                     ScheduleConfig)
    drop_group()
    t0 = time.perf_counter()
    zero = RuntimeConfig(**MAIN, schedule=ScheduleConfig(strategy="dynacomm"))
    arch = arch_of(zero)
    specs = flat_specs(arch)
    info, counts = verified("zero (full width)", zero)
    zero_plan = as_plan(info["plan"])
    zero_step = info["collectives"]["step"]
    held_to_the_plan("zero", zero_step, zero_plan, specs)
    expect = expected_launches(zero_plan, arch, (), steps=1)
    if counts != expect:
        raise AssertionError(f"verify zero: launches {counts} != {expect}")
    say("verify", f"zero: launches of the recorded step {counts} == plan")

    for scheme, names in PS_SCHEMES:
        info, counts = verified(f"ps/{scheme} (full width)", RuntimeConfig(
            **PS, compression=CompressionConfig(
                scheme, topk_fraction=TOPK_FRACTION if scheme == "topk"
                else None)))
        plan = as_plan(info["plan"])
        held_to_the_plan(f"ps/{scheme}", info["collectives"]["step"], plan,
                         specs)
        expect = expected_launches(plan, arch, names, steps=1)
        if counts != expect:
            raise AssertionError(f"verify ps/{scheme}: launches {counts} "
                                 f"!= {expect}")
        say("verify", f"ps/{scheme}: wire model and ledger exact; "
                      f"launches {counts} == plan")

    info, counts = verified("dynamic (full width)",
                            dynamic_config("dynamic"))
    plans = [as_plan(p) for p in info["plans"]]
    if tuple(sizes(p) for p in plans) != DYNAMIC_PLANS or \
            info["traces"] != 2:
        raise AssertionError(f"verify dynamic: plans {info['plans']}, "
                             f"traces {info['traces']}")
    for i, plan in enumerate(plans):
        held_to_the_plan(f"dynamic plan {i} (traced once)",
                         info["collectives"][f"plan {i}"], plan, specs)
    steps = info["steps_run"]
    expect = launches_of_plans([(plans[0], 2), (plans[1], steps - 2)], arch)
    if counts != expect:
        raise AssertionError(f"verify dynamic: launches {counts} != "
                             f"{expect}")
    say("verify", f"dynamic: {steps} steps, launches {counts} == the plans'")

    info, counts = verified("pipeline (full width)", pipeline_config())
    attn = sum(k in ("global_attn", "local_attn")
               for k in arch.layer_kinds())
    flash = 3 * attn * (info["microbatches"] + 1)
    updates = info["steps_run"] * len(specs)
    if any(info["collectives"].values()) or \
            counts.pop("flash_attention_fwd") != flash or \
            counts.pop("adamw") != updates or any(counts.values()):
        raise AssertionError(f"verify pipeline: {info['collectives']}, "
                             f"flash {flash}, adamw {updates} and nothing "
                             f"else wanted, other launches {counts}")
    say("verify", f"pipeline: every stage trace empty, partition "
                  f"{info['partition']['segments']}; flash {flash} == 3 x "
                  f"{attn} blocks x ({info['microbatches']} micro-batches "
                  f"of the step + 1 of the stage traces), adamw {updates} "
                  f"(a layer's buffer a step), no other kernel")

    cfgs = ROOT / "examples" / "runtime_configs"
    for name in SMOKE_CONFIGS:
        drop_group()
        verified(f"{name}.json (reduced)",
                 RuntimeConfig.load(str(cfgs / f"{name}.json")))
    drop_group()

    # the mutation: the full-width zero step's trace against its plan with
    # one pull bucket split in two must be flagged
    trace = [CollectiveRecord(kind=k, name=f"{k}.{i}", bytes=b,
                              dtype="float32", group_size=1)
             for i, (k, b) in enumerate(zero_step)]
    i = next(i for i, b in enumerate(zero_plan.forward) if len(b) > 1)
    b = zero_plan.forward[i]
    split = BucketPlan(forward=zero_plan.forward[:i] + (b[:1], b[1:]) +
                       zero_plan.forward[i + 1:],
                       backward=zero_plan.backward)
    codes = sorted({f.code for f in verify_schedule(trace, split, specs)})
    if codes != ["SCHED-AG-BYTES", "SCHED-AG-COUNT"]:
        raise AssertionError(f"verify: the split plan gave {codes}")
    say("verify", f"mutation: zero's trace against pull buckets "
                  f"{[len(x) for x in split.forward]} (bucket {i} split) "
                  f"flagged {codes}")
    say("verify", f"phase {time.perf_counter() - t0:.1f} s; {smi}")

def traced(fn) -> list:
    """``fn()`` under ``torch.profiler``, the card idle before and after
    the window so that it holds whole calls: the device rows of
    ``key_averages()``, less the port's spans' (a span's device row spans
    the kernels it launched, which have rows of their own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(tracing.PREFIX)]


def profile_step(rt, steady: float, phase: str = "profile") -> None:
    """One more step under ``torch.profiler``: device time by kernel (the
    twelve largest and every kernel of ``csrc/``), the device's idle
    share of an untraced steady step, and each kernel's launches in the
    trace against the wrappers' counters over the same step."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    rows = traced(lambda: rt.fit(1))
    after = launch_counts()
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    for symbol, names in TRACE_SYMBOLS.items():
        counted = sum(after[n] - before[n] for n in names)
        seen = sum(e.count for e in rows if symbol in e.key)
        if counted or seen:
            say(phase, f"{symbol}: {seen} launches in the trace, {counted} "
                       f"counted ({'equal' if seen == counted else 'DIFFER'})")
    say(phase, f"device busy {busy * 1e3:.1f} ms per step = "
               f"{100 * busy / steady:.1f}% of the untraced steady "
               f"step ({steady * 1e3:.1f} ms); idle "
               f"{100 * max(0.0, 1 - busy / steady):.1f}%")
    rows.sort(key=lambda e: -e.self_device_time_total)
    ours = re.compile("|".join(PORT_KERNELS))
    for i, e in enumerate(rows):
        if i < 12 or ours.search(e.key):      # the port's own kernels too
            say(phase, f"{e.self_device_time_total / 1e3:9.2f} ms "
                       f"{e.count:5d}x  {e.key[:80]}")


# ---------------------------------------------------------------------------
# phase 14: the checked-in smoke configs through the launcher
# ---------------------------------------------------------------------------


def drop_group() -> None:
    """Destroy the process group a runtime made (the pipeline makes none)."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def card_against_cpu(config, model=None, steps: int = STEPS) -> tuple:
    """``steps`` losses of ``config`` (``model`` overriding its arch) on the
    card and on the CPU (plain versions, held to the reference there) from
    one initial state, drawn on the CPU and restored on the card; the
    batches are numpy's on both.  Returns (largest relative gap, card,
    CPU)."""
    import tempfile
    from repro_torch.runtime import build_runtime
    (ROOT / "build").mkdir(exist_ok=True)               # ignored by git
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "init.npz")
        drop_group()
        cpu_rt = build_runtime(config, model, device="cpu")  # a gloo group
        cpu_rt.save_state(path)
        cpu = cpu_rt.fit(steps)
        drop_group()
        card_rt = build_runtime(config, model)            # an NCCL group
        card_rt.restore_state(path)
        card = card_rt.fit(steps)
        drop_group()
    gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    return gap, card, cpu


def fleet_card_against_cpu(config) -> dict:
    """``STEPS`` accepted pushes of a fleet config on the CPU and on the
    card from one initial server state (the CPU runtime's ``state_dict``,
    a host value the CPU run's commits leave alone), the card run's
    launches counted: the streams, the losses, the largest relative gap
    and the card's trainer."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import build_runtime
    dist = torch.distributed
    if dist.is_initialized():
        dist.destroy_process_group()
    cpu_rt = build_runtime(config, device="cpu")          # a gloo group
    state = cpu_rt.trainer.server.state_dict()
    cpu = cpu_rt.fit(STEPS)
    dist.destroy_process_group()
    card_rt = build_runtime(config)                       # an NCCL group
    card_rt.trainer.server.load_state_dict(state)
    reset_launch_counts()
    card = card_rt.fit(STEPS)
    counts = launch_counts()
    dist.destroy_process_group()
    gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    return dict(card=card, cpu=cpu, gap=gap, counts=counts,
                same=fleet_stream(card_rt.trainer) ==
                fleet_stream(cpu_rt.trainer), trainer=card_rt.trainer)


def zero_like(path) -> list:
    """STEPS losses of the ``zero`` runtime on a dynamic smoke config's
    model, data and seed: a plan changes no bit, so they are the dynamic
    run's."""
    from repro_torch.runtime import RuntimeConfig, ScheduleConfig, build_runtime
    cfg = RuntimeConfig.load(str(path))
    rt = build_runtime(RuntimeConfig(
        runtime="zero", arch=cfg.arch, reduced=cfg.reduced, batch=cfg.batch,
        seq=cfg.seq, optimizer=cfg.optimizer, lr=cfg.lr, seed=cfg.seed,
        aux_weight=cfg.aux_weight,
        schedule=ScheduleConfig(strategy=cfg.schedule.strategy)))
    return rt.fit(STEPS)


def phase_configs() -> None:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import main as train_main
    from repro_torch.runtime import (CompressionConfig, RuntimeConfig,
                                     build_runtime)
    cfgs = ROOT / "examples" / "runtime_configs"
    reset_launch_counts()
    zero = train_main(["--config", str(cfgs / "zero.json"), "--steps",
                       str(STEPS), "--log-every", "0"])
    local = train_main(["--config", str(cfgs / "local.json"), "--steps",
                        str(STEPS), "--log-every", "0"])
    ps = {scheme: train_main(["--config", str(cfgs / "ps.json"), "--steps",
                              str(STEPS), "--log-every", "0", "--compress",
                              scheme])
          for scheme in ("none", "int8", "topk")}
    hybrid = train_main(["--arch", HYBRID["arch"], "--reduced", "--runtime",
                         "zero", "--steps", str(STEPS), "--seq",
                         str(HYBRID_SMOKE_SEQ), "--log-every", "0"])
    dynamic = {name: train_main(["--config", str(cfgs / f"{name}.json"),
                                 "--steps", str(STEPS), "--log-every", "0"])
               for name in ("dynamic", "dynamic_ps")}
    asyncs = {name: train_main(["--config", str(cfgs / f"{name}.json"),
                                "--steps", str(STEPS), "--log-every", "0"])
              for name in (*ASYNC_CONFIGS, "fleet_async")}
    pipeline = train_main(["--config", str(cfgs / "pipeline.json"),
                           "--steps", str(STEPS), "--log-every", "0"])
    counts = launch_counts()
    # no smoke config has experts: the MoE position kernel runs in phase moe
    if counts.pop("moe_positions") != 0 or min(counts.values()) < 1:
        raise AssertionError(f"a kernel never ran in the configs, or the "
                             f"MoE's ran: {counts}")
    if ps["none"] != zero:
        raise AssertionError(f"ps.json losses {ps['none']} != zero.json "
                             f"{zero}: sync PS is the ZeRO step")
    if not all(math.isfinite(x) for v in ps.values() for x in v):
        raise AssertionError(f"non-finite ps losses {ps}")
    say("configs", f"ps.json {ps['none']} == zero.json bitwise; int8 "
                   f"{ps['int8']}; topk {ps['topk']}")
    for scheme in ("none", "int8", "topk"):
        cfg = dataclasses.replace(
            RuntimeConfig.load(str(cfgs / "ps.json")),
            compression=CompressionConfig(
                scheme, TOPK_FRACTION if scheme == "topk" else None))
        gap, card, cpu = card_against_cpu(cfg)
        if not gap <= CARD_CPU_RTOL:
            raise AssertionError(f"ps.json/{scheme}: card {card} vs CPU "
                                 f"{cpu}: rel gap {gap:.3g} > "
                                 f"{CARD_CPU_RTOL}")
        say("configs", f"ps.json/{scheme} from one initial state: card "
                       f"{card}, CPU {cpu}; rel gap {gap:.3g} (rtol "
                       f"{CARD_CPU_RTOL})")
    for name, losses in dynamic.items():
        if losses != zero_like(cfgs / f"{name}.json"):
            raise AssertionError(f"{name}.json losses {losses} != the static "
                                 f"zero run of its first plan")
        gap, card, cpu = card_against_cpu(RuntimeConfig.load(
            str(cfgs / f"{name}.json")))
        if not gap <= CARD_CPU_RTOL:
            raise AssertionError(f"{name}.json: card {card} vs CPU {cpu}: "
                                 f"rel gap {gap:.3g} > {CARD_CPU_RTOL}")
        say("configs", f"{name}.json through the launcher {losses} (bitwise "
                       f"the static zero run); from one initial state: card "
                       f"{card}, CPU {cpu}; rel gap {gap:.3g} (rtol "
                       f"{CARD_CPU_RTOL})")
    for name, losses in asyncs.items():
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}.json: non-finite losses {losses}")
        if name == "fleet_async":
            continue
        gap, card, cpu = card_against_cpu(RuntimeConfig.load(
            str(cfgs / f"{name}.json")))
        if not gap <= CARD_CPU_RTOL:
            raise AssertionError(f"{name}.json: card {card} vs CPU {cpu}: "
                                 f"rel gap {gap:.3g} > {CARD_CPU_RTOL}")
        say("configs", f"{name}.json through the launcher {losses}; from one "
                       f"initial state: card {card}, CPU {cpu}; rel gap "
                       f"{gap:.3g} (rtol {CARD_CPU_RTOL})")
    gap, card, cpu = card_against_cpu(RuntimeConfig.load(
        str(cfgs / "pipeline.json")))
    if not gap <= CARD_CPU_RTOL or not all(math.isfinite(x)
                                           for x in pipeline):
        raise AssertionError(f"pipeline.json: launcher {pipeline}; card "
                             f"{card} vs CPU {cpu}: rel gap {gap:.3g} > "
                             f"{CARD_CPU_RTOL}")
    say("configs", f"pipeline.json through the launcher {pipeline}; from "
                   f"one initial state: card {card}, CPU {cpu}; rel gap "
                   f"{gap:.3g} (rtol {CARD_CPU_RTOL})")
    fleet = RuntimeConfig.load(str(cfgs / "fleet_async.json"))
    for scheme, names in (("none", ()), PS_SCHEMES[0]):
        run = fleet_card_against_cpu(dataclasses.replace(
            fleet, compression=CompressionConfig(scheme)))
        tr = run.pop("trainer")
        L = len(tr.specs)
        # a kernel a layer of each accepted push and of each partial walk
        want = sum(n * L + sum(len(b) for b in p.backward[:x])
                   for h in tr.push_history.values() for p, n, x in h)
        if not run["same"] or not run["gap"] <= CARD_CPU_RTOL or \
                any(run["counts"][k] != want for k in names):
            raise AssertionError(f"fleet_async.json/{scheme}: {run}, want "
                                 f"{want} launches of {names}")
        say("configs", f"fleet_async.json/{scheme} from one initial state: "
                       f"the CPU's events, re-plans and push histories "
                       f"{history_runs(tr)}; "
                       f"card {run['card']}, CPU {run['cpu']}; rel gap "
                       f"{run['gap']:.3g} (rtol {CARD_CPU_RTOL}); launches "
                       f"{ {k: run['counts'][k] for k in names} } == "
                       f"{L} layers x accepted pushes + the crash's partial "
                       f"walk = {want}")
    if not all(math.isfinite(x) for x in hybrid):
        raise AssertionError(f"non-finite reduced {HYBRID['arch']} losses "
                             f"{hybrid}")
    # reduced recurrentgemma-2b with 3 layers: (rglru, rglru, local_attn)
    from repro_torch.configs import get_config
    arch = dataclasses.replace(get_config(HYBRID["arch"]).reduced(),
                               num_layers=3)
    gap, card, cpu = card_against_cpu(RuntimeConfig(
        runtime="zero", arch=HYBRID["arch"], reduced=True, batch=2,
        seq=HYBRID_SMOKE_SEQ), arch)
    if not gap <= HYBRID_CARD_CPU_RTOL:
        raise AssertionError(f"reduced {HYBRID['arch']}: card {card} vs CPU "
                             f"{cpu}: rel gap {gap:.3g} > "
                             f"{HYBRID_CARD_CPU_RTOL}")
    say("configs", f"reduced {HYBRID['arch']} {arch.layer_kinds()} at seq "
                   f"{HYBRID_SMOKE_SEQ} from one initial state: card {card}, "
                   f"CPU {cpu}; rel gap {gap:.3g} (rtol "
                   f"{HYBRID_CARD_CPU_RTOL}); the launcher's 2-layer run "
                   f"{hybrid}")
    gap = max(abs(a - b) / abs(b) for a, b in zip(zero, local))
    if not gap <= LOSS_RTOL:
        raise AssertionError(f"zero {zero} vs local {local}: rel gap "
                             f"{gap:.3g} > {LOSS_RTOL}")
    say("configs", f"zero.json {zero}; local.json {local}; rel gap "
                   f"{gap:.3g} (rtol {LOSS_RTOL}); launches {counts}")
    base = RuntimeConfig.load(str(cfgs / "zero.json"))
    for strategy in ("sequential", "lbl", "ibatch"):
        cfg = dataclasses.replace(base, schedule=dataclasses.replace(
            base.schedule, strategy=strategy))
        rt = build_runtime(cfg)
        got = rt.fit(STEPS)
        if got != zero:
            raise AssertionError(f"zero/{strategy} losses {got} != "
                                 f"zero/dynacomm {zero}")
        say("configs", f"zero/{strategy}: {len(rt.plan.forward)} pull / "
                       f"{len(rt.plan.backward)} push buckets, losses "
                       f"bitwise equal to dynacomm")


# ---------------------------------------------------------------------------
# phase 15: the training loop and the stacked-layer model at full width
# ---------------------------------------------------------------------------


def loop_pipe(cfg):
    """The main path's data: ``SyntheticText`` batches of 2 x 1024, seed 0."""
    from repro_torch.data import SyntheticText
    return SyntheticText(cfg.vocab_size, MAIN["seq"], MAIN["batch"], seed=0)


def stamped(pipe, stamps: list):
    """``pipe``'s batches, the host time of each fetch appended to
    ``stamps``: ``TrainLoop`` reads each loss to the host (a sync) before
    it fetches the next batch, so consecutive stamps bound one step."""
    for batch in pipe:
        stamps.append(time.perf_counter())
        yield batch


def loop_run(cfg, accum: int = 1, steps: int = STEPS, **loop_args) -> dict:
    """``steps`` steps of ``TrainLoop`` (AdamW at the runtime's default lr,
    no remat, a log line a step) from seed 0 on the card: losses, the
    kernels' launches, seconds a step, peak, and the final state."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import adamw
    from repro_torch.train import TrainLoop
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(cfg=cfg, optimizer=adamw(LOOP_LR), accum_steps=accum,
                     log_every=1, **loop_args)
    stamps: list = []
    reset_launch_counts()
    params, opt, losses = loop.run(
        torch.Generator(device="cuda").manual_seed(0),
        stamped(loop_pipe(cfg), stamps), steps)
    torch.cuda.synchronize()
    return dict(losses=losses, counts=launch_counts(), params=params,
                opt=opt, secs=[b - a for a, b in zip(stamps, stamps[1:])],
                peak=torch.cuda.max_memory_allocated())


def loop_by_hand(cfg) -> list:
    """The same steps through ``build_train_step`` (the ``local``
    runtime's step) driven by hand: init, batches and update as above."""
    from repro_torch import tree
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import build_train_step
    free_cuda()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32, "cuda")
    leaves = [x.requires_grad_() for x in tree.leaves(params)]
    opt = adamw(LOOP_LR)
    state = opt.init(leaves)
    step = build_train_step(cfg, opt, remat=False)
    pipe, losses = loop_pipe(cfg), []
    for i in range(STEPS):
        batch = {k: v.cuda() for k, v in pipe.batch(i).items()}
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    del params, state, leaves
    return losses


def flash_only(counts: dict, n: int, adamw: int = 0) -> None:
    """``counts`` hold ``n`` flash launches, ``adamw`` AdamW updates and
    no other kernel's."""
    want = {name: 0 for name in counts}
    want.update(flash_attention_fwd=n, adamw=adamw)
    if counts != want:
        raise AssertionError(f"launches {counts} != {want}")


def reckon_loop_peak(cfg) -> dict:
    """The reckoning written before the first run: weights, gradients and
    two AdamW moments in fp32 (4 copies), plus the activations autograd
    keeps without remat (a block: its input, the norms' and projections'
    outputs, q / k / v and the attention output, the MLP's up, gate and
    product, about 2 x 1024 x (12 d + 4 d_ff) fp32; the logits' CE keeps
    ~3 fp32 copies of B x T x vocab) and the plain attention backward's
    transient (B, H, T, T) scores (a few fp32 copies of one block's)."""
    from repro_torch.models import param_count
    n_tok = MAIN["batch"] * MAIN["seq"]
    weights = 4 * param_count(cfg)
    block = 4 * n_tok * (12 * cfg.d_model + 4 * cfg.d_ff)
    logits = 3 * 4 * n_tok * cfg.vocab_size
    scores = 4 * 4 * MAIN["batch"] * cfg.num_heads * MAIN["seq"] ** 2
    return dict(weights=4 * weights,
                total=4 * weights + cfg.num_layers * block + logits + scores)


def train_loop_on_the_card(smi: str) -> dict:
    from repro_torch import tree
    from repro_torch.configs import get_config
    cfg = get_config(MAIN["arch"])
    reckon = reckon_loop_peak(cfg)
    say("loop", f"{cfg.name}: {cfg.num_layers} layers, d_model "
                f"{cfg.d_model}, GQA {cfg.num_heads}/{cfg.num_kv_heads}, "
                f"vocab {cfg.vocab_size}; TrainLoop, AdamW {LOOP_LR}, no "
                f"remat, batch {MAIN['batch']} x {MAIN['seq']}; peak "
                f"reckoned {reckon['total'] / 2**30:.2f} GiB (4 fp32 copies "
                f"{reckon['weights'] / 2**30:.2f})")
    run = loop_run(cfg)
    updates = STEPS * len(tree.leaves(run["params"]))
    flash_only(run["counts"], STEPS * cfg.num_layers, updates)
    by_hand = loop_by_hand(cfg)
    if run["losses"] != by_hand:
        raise AssertionError(f"TrainLoop losses {run['losses']} != "
                             f"build_train_step's {by_hand}")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"non-finite losses {run['losses']}")
    steady = sum(run["secs"][1:]) / len(run["secs"][1:])
    tokens = MAIN["batch"] * MAIN["seq"]
    say("loop", f"losses {run['losses']} == build_train_step's by hand "
                f"(bitwise); launches {run['counts']}")
    say("loop", f"step seconds {[round(s, 4) for s in run['secs']]}; "
                f"steady {steady * 1e3:.1f} ms/step (steps 2-{STEPS}), "
                f"{tokens / steady:.1f} tokens/s; peak "
                f"{run['peak'] / 2**30:.2f} GiB against the reckoned "
                f"{reckon['total'] / 2**30:.2f} GiB ({smi})")
    losses = run["losses"]
    del run
    acc = loop_run(cfg, accum=2)
    flash_only(acc["counts"], 2 * STEPS * cfg.num_layers, updates)
    gap = max(abs(a - b) / abs(b) for a, b in zip(acc["losses"], losses))
    if gap > ACCUM_RTOL:
        raise AssertionError(f"accum_steps=2 losses {acc['losses']} vs "
                             f"{losses}: gap {gap:.2e} > {ACCUM_RTOL}")
    say("loop", f"accum_steps=2: losses {acc['losses']}, largest relative "
                f"gap {gap:.2e} (<= {ACCUM_RTOL}); launches "
                f"{acc['counts']['flash_attention_fwd']} flash; peak "
                f"{acc['peak'] / 2**30:.2f} GiB")
    del acc
    return dict(losses=losses, steady=steady,
                flash=STEPS * cfg.num_layers)


def loop_checkpoint_round_trip() -> None:
    """``checkpoint_every=1`` at ``LOOP_CKPT_LAYERS`` layers of full width:
    the file of the last step, loaded into the run's own template, holds
    its parameters and optimizer state bit for bit."""
    import tempfile
    from repro_torch import tree
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.train.loop import opt_tree
    cfg = dataclasses.replace(get_config(MAIN["arch"]),
                              num_layers=LOOP_CKPT_LAYERS)
    (ROOT / "build").mkdir(exist_ok=True)               # ignored by git
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "loop.npz")
        run = loop_run(cfg, steps=2, checkpoint_path=path,
                       checkpoint_every=1)
        want = {"params": run["params"],
                "opt": opt_tree(run["opt"], run["params"])}
        size = Path(path).stat().st_size
        loaded, step = load_checkpoint(path, want)
    if step != 2:
        raise AssertionError(f"checkpoint of step {step}, not 2")
    leaves = tree.leaves(want)
    for got, ref in zip(tree.leaves(loaded), leaves):
        assert_bitwise(torch.from_numpy(got), ref.detach().cpu(),
                       "a checkpoint leaf")
    say("loop", f"checkpoint round trip at {LOOP_CKPT_LAYERS} layers of "
                f"full width: step 2's {len(leaves)} leaves "
                f"({size / 2**30:.2f} GiB on disk) bitwise")


def reckon_scanned_peaks(cfg) -> dict:
    """Reckoned before the first run: on top of the stacked weights and
    the unrolled step's gradients kept for the comparison (2 fp32 copies),
    each variant holds its gradients twice at the end (the groups' and
    their stack: ``torch.unbind``'s backward) and its saved activations:
    every block's (``reckon_loop_peak``) without remat, one (B, T, d)
    input a group with remat, one a chunk of ``SCANNED_REMAT_SQRT`` groups
    with the second level; plus one block recomputed, the logits' CE and
    the attention backward's scores."""
    from repro_torch.models import param_count
    n_tok = MAIN["batch"] * MAIN["seq"]
    w = 4 * param_count(cfg)
    block = 4 * n_tok * (12 * cfg.d_model + 4 * cfg.d_ff)
    carry = 4 * n_tok * cfg.d_model
    rest = (3 * 4 * n_tok * cfg.vocab_size + block
            + 4 * 4 * MAIN["batch"] * cfg.num_heads * MAIN["seq"] ** 2)
    base = 2 * w + 2 * w + rest
    return {"off": base + cfg.num_layers * block,
            "remat": base + cfg.num_layers * carry,
            f"remat_sqrt={SCANNED_REMAT_SQRT}":
                base + cfg.num_layers // SCANNED_REMAT_SQRT * carry
                + SCANNED_REMAT_SQRT * carry}


def sqrt_remat_flash(groups: int, r: int) -> int:
    """Flash launches of one two-level-remat step over ``groups`` groups of
    one attention block: the forward, the chunks' recompute and the
    groups' recompute.  A chunk's recompute stops once it has rebuilt
    what the chunk saved, the input of its last group (non-reentrant
    checkpoint's early stop), so it runs ``r - 1`` of its ``r`` groups."""
    return groups + (groups - groups // r) + groups


def scanned_on_the_card(smi: str) -> dict:
    """Full-width granite-3-2b on the stacked layout: ``train_loss_scanned``
    and its gradients (unstacked) bitwise ``train_loss`` with per-block
    remat, at remat off, per group and two-level; flash launches exact."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params, model, scanned
    cfg = get_config(MAIN["arch"])
    free_cuda()
    sp = scanned.stack_layer_params(cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.float32,
        "cuda"))
    stacked = [x.requires_grad_() for x in tree.leaves(sp)]
    # the per-layer view of the same storage (no copy)
    unrolled = tree.tree_map(lambda x: x.detach().requires_grad_(),
                             scanned.unstack_layer_params(cfg, sp))
    batch = {k: v.cuda() for k, v in loop_pipe(cfg).batch(0).items()}
    reckon = reckon_scanned_peaks(cfg)
    say("loop", f"stacked {cfg.name}: {scanned.group_count(cfg)[0]} groups"
                f" of {len(cfg.layer_pattern)}; peaks reckoned "
                + ", ".join(f"{k} {v / 2**30:.2f} GiB"
                            for k, v in reckon.items()))

    def step(fn, leaves):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = fn()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        return (loss.detach(), grads, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(), launch_counts())

    u_leaves = tree.leaves(unrolled)
    u_loss, u_grads, u_secs, u_peak, u_counts = step(
        lambda: model.train_loss(cfg, unrolled, batch, remat=True), u_leaves)
    flash_only(u_counts, 2 * cfg.num_layers)
    say("loop", f"unrolled, per-block remat: loss {u_loss.item():.6f}, "
                f"{u_secs * 1e3:.1f} ms, peak {u_peak / 2**30:.2f} GiB, "
                f"flash {u_counts['flash_attention_fwd']}")
    out = {}
    for name, kw, flash in (
            ("off", dict(remat=False), cfg.num_layers),
            ("remat", dict(remat=True), 2 * cfg.num_layers),
            (f"remat_sqrt={SCANNED_REMAT_SQRT}",
             dict(remat=True, remat_sqrt=SCANNED_REMAT_SQRT),
             sqrt_remat_flash(cfg.num_layers, SCANNED_REMAT_SQRT))):
        loss, grads, secs, peak, counts = step(
            lambda: scanned.train_loss_scanned(cfg, sp, batch, **kw),
            stacked)
        flash_only(counts, flash)
        assert_bitwise(loss, u_loss, f"scanned loss ({name})")
        per_layer = tree.leaves(scanned.unstack_layer_params(
            cfg, tree.unflatten(tree.structure(sp), list(grads))))
        for got, want in zip(per_layer, u_grads):
            assert_bitwise(got, want, f"a scanned gradient ({name})")
        del grads, per_layer
        say("loop", f"scanned, {name}: loss and {len(u_grads)} gradient "
                    f"leaves bitwise the unrolled step's; {secs * 1e3:.1f} "
                    f"ms; peak {peak / 2**30:.2f} GiB (reckoned "
                    f"{reckon[name] / 2**30:.2f}); flash "
                    f"{counts['flash_attention_fwd']} ({smi})")
        out[name] = dict(secs=secs, peak=peak, flash=flash)
    del sp, stacked, unrolled, u_grads, u_leaves
    free_cuda()
    return out


def scanned_hybrid_forward() -> dict:
    """recurrentgemma-2b at full width on the stacked layout (period 3: 8
    groups + 2 remainder layers): one forward, logits and aux bitwise
    ``forward``'s, the scan and flash (hd 256) launched once a block."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params, model, scanned
    cfg = get_config(HYBRID["arch"])
    free_cuda()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32, "cuda")
    sp = scanned.stack_layer_params(cfg, params)
    del params
    unrolled = scanned.unstack_layer_params(cfg, sp)
    batch = {k: v.cuda() for k, v in loop_pipe(cfg).batch(0).items()}
    kinds = cfg.layer_kinds()
    want = {"flash_attention_fwd": kinds.count("local_attn")
            + kinds.count("global_attn"), "rglru_scan": kinds.count("rglru")}
    runs = []
    with torch.no_grad():
        for fn in (lambda: scanned.forward_scanned(cfg, sp, batch,
                                                   remat=False),
                   lambda: model.forward(cfg, unrolled, batch)):
            reset_launch_counts()
            logits, _, aux = fn()
            counts = {k: v for k, v in launch_counts().items() if v}
            if counts != want:
                raise AssertionError(f"launches {counts} != {want}")
            runs.append((logits, aux))
    assert_bitwise(runs[0][0], runs[1][0], "scanned recurrentgemma logits")
    assert_bitwise(runs[0][1], runs[1][1], "scanned recurrentgemma aux")
    n_groups, rem = scanned.group_count(cfg)
    say("loop", f"stacked {cfg.name}: {n_groups} groups of "
                f"{len(cfg.layer_pattern)} + {rem} remainder layers; logits "
                f"{tuple(runs[0][0].shape)} and aux bitwise forward's; "
                f"launches {want} each")
    del runs, sp, unrolled
    free_cuda()
    return want


def phase_loop(smi: str) -> dict:
    run = train_loop_on_the_card(smi)
    loop_checkpoint_round_trip()
    run["scanned"] = scanned_on_the_card(smi)
    run["hybrid"] = scanned_hybrid_forward()
    return run


# ---------------------------------------------------------------------------
# phase 16: the structure checks on fake tensors (subprocesses, no card)
# ---------------------------------------------------------------------------


def zero_operand_bytes(cfg, world: int) -> tuple:
    """(all-gather, reduce-scatter) operand bytes of one ZeRO step at
    ``world`` ranks by the FlatSpec math: each layer's shard pulled once,
    its padded buffer pushed once, in fp32."""
    from repro_torch.dist.collectives import make_flat_spec
    from repro_torch.models import model
    specs = [make_flat_spec(t, world) for t in model.sched_layer_trees(
        model.param_shapes(cfg))]
    return (4 * sum(s.shard_size for s in specs),
            4 * sum(s.padded for s in specs))


def structure_runs(tmp: Path) -> dict:
    """The dry runs, all started at once, each a process of its own on
    the CPU with no card visible; waits for all and kills any left."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    from repro_torch.launch.zero_dryrun import STRATEGIES
    # one process a strategy: each fake step takes ~30 s of one core
    cmds = {f"zero-{s}": ["repro_torch.launch.zero_dryrun", "--arch",
                          MAIN["arch"], "--strategies", s]
            for s in STRATEGIES}
    cmds["zero-costs"] = ["repro_torch.launch.zero_dryrun", "--arch",
                          MAIN["arch"], "--skip-lowering"]
    for arch in STRUCTURE_STATE_BYTES:
        cmds[arch] = ["repro_torch.launch.dryrun", "--arch", arch,
                      "--shape", "train_4k"]
    procs = {}
    try:
        for name, args in cmds.items():
            out = tmp / f"{name}.jsonl"
            log = open(tmp / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", *args, "--out", str(out)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT),
                log, out)
        for name, (proc, log, _) in procs.items():
            proc.wait(timeout=STRUCTURE_TIMEOUT_S)
            log.close()
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    results = {}
    for name, (proc, _, out) in procs.items():
        text = (tmp / f"{name}.log").read_text()
        for line in text.splitlines():
            say("structure", f"{name}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{cmds[name]} exited {proc.returncode}")
        results[name] = json.loads(out.read_text().splitlines()[-1])
    return results


def phase_structure() -> None:
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core import plan_from_decision, schedule
    from repro_torch.launch.zero_dryrun import STRATEGIES, tpu_costs
    from repro_torch.models import num_sched_layers
    (ROOT / "build").mkdir(exist_ok=True)               # ignored by git
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        res = structure_runs(Path(tmp))
    wall = time.perf_counter() - t0
    cfg = get_config(MAIN["arch"])
    costs_only = res["zero-costs"]
    world = res["zero-dynacomm"]["fake_world"]
    ag, rs = zero_operand_bytes(cfg, world)
    costs = tpu_costs(MAIN["arch"], "train_4k", world)
    for strat in STRATEGIES:
        rec = res[f"zero-{strat}"]["strategies"][strat]
        ref = costs_only["strategies"][strat]
        plan = plan_from_decision(*schedule(costs, strat),
                                  num_sched_layers(cfg))
        checks = {
            "all-gathers = F": rec["recorded_all_gathers"]
            == rec["fwd_buckets"] == len(plan.forward),
            "reduce-scatters = B": rec["recorded_reduce_scatters"]
            == rec["bwd_buckets"] == len(plan.backward),
            "all-gather bytes": rec["all_gather_bytes"] == ag,
            "reduce-scatter bytes": rec["reduce_scatter_bytes"] == rs,
            "fm and steady state": all(rec[k] == v for k, v in ref.items()),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"zero_dryrun {strat}: {bad} ({rec})")
        say("structure", f"zero {world} fake ranks, {strat}: "
                         f"{rec['recorded_all_gathers']} all-gathers / "
                         f"{rec['recorded_reduce_scatters']} reduce-scatters "
                         f"= plan; operand bytes {ag} / {rs} = FlatSpec; "
                         f"peak live {rec['peak_live_bytes']} B; fm "
                         f"{rec['fm_iteration_s']:.4f} s (TPU cost model)")
    for arch, (params_b, opt_b) in STRUCTURE_STATE_BYTES.items():
        rec = res[arch]
        st = rec.get("state_bytes_per_device", {})
        if rec["status"] != "ok" or (st.get("params"), st.get("opt")) != \
                (params_b, opt_b):
            raise AssertionError(f"dryrun {arch}: {rec.get('status')}, "
                                 f"state {st} != {(params_b, opt_b)}")
        say("structure", f"{arch} x train_4k x 16x16 on fake tensors: "
                         f"per device params {st['params']} B, opt "
                         f"{st['opt']} B = the rules' reckoning; activation "
                         f"peak {rec['activation_peak_bytes']} B, step peak "
                         f"{rec['step_peak_bytes']} B (a replica's "
                         f"micro-batch {rec['micro_batch']}); flops/device "
                         f"{rec['flops_per_device']:.4e}, useful "
                         f"{rec['useful_flop_ratio']:.4f}, compute term "
                         f"{rec['roofline']['compute_s']:.4f} s; fake step "
                         f"{rec['fake_step_s']} s")
    say("structure", f"{len(res)} dry runs side by side in {wall:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the examples on the card, and gemma2-2b served at full width
# ---------------------------------------------------------------------------


def examples_support():
    """``tests/helpers/torch_examples.py``, shared with the examples' tests:
    the examples' runner, their text mask, the reference's texts at the
    defaults and the host draws of the card / CPU twins."""
    import importlib.util
    if "torch_examples" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "torch_examples", ROOT / "tests" / "helpers" / "torch_examples.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["torch_examples"] = module
    return sys.modules["torch_examples"]


def computations(rt) -> int:
    """Gradient computations an async runtime's loop has started (0 for a
    synchronous runtime or before the first push)."""
    loop = getattr(rt.trainer, "trainer", rt.trainer)
    state = getattr(loop, "_loop", None)
    return sum(state.attempts.values()) if state is not None else 0


def commits(rt) -> int:
    """Optimizer steps a runtime's parameter server has committed (its
    version; 0 where the runtime has no server)."""
    loop = getattr(rt.trainer, "trainer", rt.trainer)
    server = getattr(loop, "server", None)
    return server.version if server is not None else 0


def count_gap(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()}


class ExampleRecorder:
    """While an example runs: each runtime ``build_runtime`` makes, with
    the losses, launches and gradient computations of each of its ``fit``
    calls, and each ``batched_generate``'s last-position prefill logits and
    launches in its prefill and in all.  The examples import both names
    when they run, so patching the modules' attributes reaches them."""

    def __init__(self):
        self.fits, self.generates = [], []

    def __enter__(self):
        import repro_torch.runtime as runtime
        from repro_torch.kernels import launch_counts
        from repro_torch.serve import decode
        build, generate = self._saved = (runtime.build_runtime,
                                         decode.batched_generate)

        def recorded_build(*a, **k):
            rt = build(*a, **k)
            fit = rt.fit

            def recorded_fit(steps, **kw):
                before, made = launch_counts(), computations(rt)
                committed = commits(rt)
                out = fit(steps, **kw)
                self.fits.append(dict(
                    rt=rt, units=len(out), losses=list(out),
                    counts=count_gap(launch_counts(), before),
                    computations=computations(rt) - made,
                    commits=commits(rt) - committed))
                return out
            rt.fit = recorded_fit
            return rt

        def recorded_generate(cfg, *a, on_step=None, **k):
            before, prefill, first = launch_counts(), {}, []

            def hook(i, logits, caches):
                if i == 0:
                    prefill.update(launch_counts())
                    first.append(logits[:, -1].float().cpu())
                if on_step is not None:
                    on_step(i, logits, caches)
            out = generate(cfg, *a, on_step=hook, **k)
            self.generates.append(dict(
                cfg=cfg, logits=first[0], prefill=count_gap(prefill, before),
                counts=count_gap(launch_counts(), before)))
            return out
        runtime.build_runtime = recorded_build
        decode.batched_generate = recorded_generate
        return self

    def __exit__(self, *exc):
        import repro_torch.runtime as runtime
        from repro_torch.serve import decode
        runtime.build_runtime, decode.batched_generate = self._saved


def attention_blocks(arch) -> int:
    return sum(k in ("global_attn", "local_attn") for k in arch.layer_kinds())


def launches_of_fits(fits) -> dict:
    """What an example's ``fit`` calls should launch, from each runtime's
    own plans: ``expected_launches`` a synchronous step, the plan sequence
    of the re-planning runtimes (``launches_of_plans`` over their events),
    3 flash a block and micro-batch a pipeline step, 2 flash a block a
    gradient computation of the async runtimes, and under AdamW one
    update a sched layer's buffer a step or a commit of the server."""
    total: dict = {}
    runtimes = {id(f["rt"]): f["rt"] for f in fits}
    for key, rt in runtimes.items():
        mine = [f for f in fits if id(f["rt"]) == key]
        units = sum(f["units"] for f in mine)
        made = sum(f["computations"] for f in mine)
        name, arch = rt.config.runtime, rt.arch
        adamw = rt.config.optimizer == "adamw"
        layers = arch.num_layers + 2 if adamw else 0
        if name in ("zero", "ps"):
            want = expected_launches(rt.plan, arch, (), units, adamw)
        elif name in ("dynamic", "dynamic-ps"):
            every = rt.config.schedule.reschedule_every
            want = launches_of_plans(
                [(e.plan, min(every, units - e.epoch * every))
                 for e in rt.events], arch, (), adamw)
        elif name == "pipeline":
            want = {"flash_attention_fwd": 3 * attention_blocks(arch)
                    * rt.trainer.num_microbatches * units,
                    "adamw": layers * units}
        else:
            want = {"flash_attention_fwd": 2 * attention_blocks(arch) * made,
                    "adamw": layers * sum(f["commits"] for f in mine)}
        for k, n in want.items():
            total[k] = total.get(k, 0) + n
    return total


def check_example_launches(name: str, counts: dict, rec) -> str:
    """The example's launches: its fits' against ``launches_of_fits``, each
    served prefill one flash an attention block and its decode none, and
    nothing launched outside those (the smoke CNN's pushes launch no
    kernel of csrc/).  Returns a summary."""
    fitted: dict = {}
    for f in rec.fits:
        for k, n in f["counts"].items():
            fitted[k] = fitted.get(k, 0) + n
    want = {k: 0 for k in counts}
    want.update(launches_of_fits(rec.fits))
    if {k: fitted.get(k, 0) for k in counts} != want:
        raise AssertionError(f"{name}: its runtimes launched {fitted}, "
                             f"their plans ask {want}")
    served = {k: 0 for k in counts}
    for g in rec.generates:
        attn = attention_blocks(g["cfg"])
        if g["prefill"]["flash_attention_fwd"] != attn or \
                g["counts"] != g["prefill"] or \
                any(n for k, n in g["prefill"].items()
                    if k != "flash_attention_fwd"):
            raise AssertionError(f"{name}: a prefill launched "
                                 f"{g['prefill']}, the whole generate "
                                 f"{g['counts']}; want flash {attn} in the "
                                 f"prefill and nothing in decode")
        served["flash_attention_fwd"] += attn
    outside = {k: n - want[k] - served[k] for k, n in counts.items()}
    if any(outside.values()):
        raise AssertionError(f"{name}: launches {counts} outside its runtimes"
                             f" and prefills: {outside}")
    runs = [f"{rt.config.runtime} x "
            f"{sum(f['units'] for f in rec.fits if f['rt'] is rt)}"
            for rt in {id(f["rt"]): f["rt"] for f in rec.fits}.values()]
    return (f"launches {dict((k, n) for k, n in counts.items() if n)} == "
            f"the plans of {runs or 'no runtime'}"
            + (f" + {len(rec.generates)} prefill(s), none in decode"
               if rec.generates else ""))


def finite_example_losses(name: str, text: str, rec) -> None:
    """Every loss the example printed (the mask hides finite ones only, so
    a NaN would already differ from the reference's text) and every loss
    its ``fit`` calls returned is finite."""
    ex = examples_support()
    returned = [x for f in rec.fits for x in f["losses"]]
    printed = [float(x) for x in ex.printed_losses(text)]
    if not all(math.isfinite(x) for x in (*returned, *printed)) or \
            re.search(r"(?i)\b(nan|inf|infinity)\b", text):
        raise AssertionError(f"torch_{name}.py: losses {returned} returned, "
                             f"{printed} printed: not all finite")


def examples_at_their_defaults() -> dict:
    """Each example in this process at the reference's defaults with no
    ``--device`` (so on the card), its text printed: masked, it must equal
    the reference's at its defaults (``EXAMPLE_TEXTS``); its losses must
    be finite and its launches are held against its plans.  Returns each
    example's seconds."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    ex = examples_support()
    secs = {}
    for name in ex.EXAMPLES:
        drop_group()
        reset_launch_counts()
        t0 = time.perf_counter()
        with ExampleRecorder() as rec:
            text = ex.run_example(ex.example_path(name))
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 1)
        counts = launch_counts()
        print(f"[examples] torch_{name}.py ({secs[name]} s):")
        print("".join(f"    {line}\n" for line in text.splitlines()),
              end="", flush=True)
        want = (ex.EXAMPLE_TEXTS / f"{name}.txt").read_text().splitlines()
        got = ex.mask_example_text(text).splitlines()
        if got != want:
            diff = [(a, b) for a, b in zip(got, want) if a != b]
            raise AssertionError(f"torch_{name}.py at its defaults: "
                                 f"{len(got)} lines against the reference's "
                                 f"{len(want)}, masked; first differences "
                                 f"{diff[:3]}")
        finite_example_losses(name, text, rec)
        launched = check_example_launches(name, counts, rec)
        say("examples", f"torch_{name}.py: the reference's text, masked; "
                        f"{sum(len(f['losses']) for f in rec.fits)} losses "
                        f"returned and {len(ex.printed_losses(text))} printed,"
                        f" finite; {launched}")
        del rec
        free_cuda()
    drop_group()
    return secs


def example_twin(name: str) -> dict:
    """``examples/torch_<name>.py`` at its tests' small flags on the card
    and with ``--device cpu``, the card's run drawing its weights and
    samples on the host (``host_draws``), so both start from one state:
    the same text once masked; its printed losses
    the CPU's to CARD_CPU_RTOL and one unit of their last digit; each
    ``fit``'s losses the CPU's to CARD_CPU_RTOL; each served prefill's
    last logits within SERVE_CARD_CPU_ATOL of the CPU's; all finite.
    Returns the card run's launches and the worst gaps."""
    import contextlib
    from repro_torch.kernels import launch_counts, reset_launch_counts
    ex = examples_support()
    argv = ex.EXAMPLES[name]
    runs = []
    for extra in ((), ("--device", "cpu")):
        drop_group()
        reset_launch_counts()
        draws = contextlib.nullcontext() if extra else ex.host_draws()
        with ExampleRecorder() as rec, draws:
            text = ex.run_example(ex.example_path(name), (*argv, *extra))
        finite_example_losses(name, text, rec)
        runs.append((text, rec, launch_counts()))
    drop_group()
    (card, crec, counts), (cpu, cpurec, _) = runs
    where = f"torch_{name}.py {' '.join(argv)}"
    if ex.mask_example_text(card) != ex.mask_example_text(cpu):
        diff = [(a, b) for a, b in zip(ex.mask_example_text(card).splitlines(),
                                       ex.mask_example_text(cpu).splitlines())
                if a != b]
        raise AssertionError(f"{where}: the card's masked text differs from "
                             f"the CPU's: {diff[:3]}")
    printed = ex.printed_losses_agree(ex.printed_losses(card),
                                      ex.printed_losses(cpu), CARD_CPU_RTOL)
    if len(crec.fits) != len(cpurec.fits) or \
            len(crec.generates) != len(cpurec.generates):
        raise AssertionError(f"{where}: {len(crec.fits)} fits and "
                             f"{len(crec.generates)} generates on the card, "
                             f"{len(cpurec.fits)} and {len(cpurec.generates)}"
                             f" on the CPU")
    fits = max([rel_gap(a["losses"], b["losses"])
                for a, b in zip(crec.fits, cpurec.fits)], default=0.0)
    logits = max([(a["logits"] - b["logits"]).abs().max().item()
                  for a, b in zip(crec.generates, cpurec.generates)],
                 default=0.0)
    if not (fits <= CARD_CPU_RTOL and logits <= SERVE_CARD_CPU_ATOL):
        raise AssertionError(f"{where}: card against CPU from one state: "
                             f"fit losses rel gap {fits:.3g} (rtol "
                             f"{CARD_CPU_RTOL}), prefill logits {logits:.3g} "
                             f"(atol {SERVE_CARD_CPU_ATOL})")
    return dict(counts=counts, printed=printed, fits=fits, logits=logits,
                losses=sum(len(f["losses"]) for f in crec.fits)
                + len(ex.printed_losses(card)))


def examples_card_against_cpu() -> None:
    """``example_twin`` of each example."""
    ex = examples_support()
    gaps = {name: example_twin(name) for name in ex.EXAMPLES}
    say("examples", f"the {len(gaps)} examples at their tests' small flags, "
                    f"the card from the CPU's draws: masked text == the "
                    f"CPU's; {sum(g['losses'] for g in gaps.values())} losses"
                    f" compared, fit losses within "
                    f"{max(g['fits'] for g in gaps.values()):.3g} (rtol "
                    f"{CARD_CPU_RTOL}), printed ones within "
                    f"{max(g['printed'] for g in gaps.values()):.3g} of their "
                    f"bound (rtol and a unit of the last digit), served "
                    f"prefill logits within "
                    f"{max(g['logits'] for g in gaps.values()):.3g} (atol "
                    f"{SERVE_CARD_CPU_ATOL})")


# (b, h, hkv, t, hd, window, softcap): the examples' attention calls —
# edge_training / bandwidth_drift (hd 128 at 4 heads), edge_ps,
# dynamic_ps, edge_pipeline's micro-batch, elastic_fleet, serving's
# prefill (reduced gemma2-2b: hd 64, window 64, softcap 50) and its window
# biting past T = 64
EXAMPLE_FLASH = ((8, 4, 4, 128, 128, 0, 0.0), (8, 4, 4, 32, 64, 0, 0.0),
                 (4, 4, 4, 32, 64, 0, 0.0), (2, 4, 4, 64, 64, 0, 0.0),
                 (2, 4, 4, 16, 64, 0, 0.0), (4, 4, 4, 32, 64, 64, 50.0),
                 (4, 4, 4, 130, 64, 64, 50.0))


def flash_at_the_examples(dev) -> None:
    from repro_torch.kernels.flash_attention.ops import (_ref_fwd,
                                                         flash_attention)
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    with torch.no_grad():
        for b, h, hkv, t, hd, window, cap in EXAMPLE_FLASH:
            q, k, v = _qkv(gen, dev, b, h, hkv, t, hd, torch.float32, True)
            err = (flash_attention(q, k, v, True, window, cap)
                   - _ref_fwd(q, k, v, True, window, cap)).abs().max().item()
            if not err <= F32_ATOL:
                raise AssertionError(f"flash at an example's shape "
                                     f"{(b, h, hkv, t, hd, window, cap)}: "
                                     f"max abs err {err:.3g} > {F32_ATOL}")
            worst = max(worst, err)
    say("examples", f"flash_attention_fwd at the examples' "
                    f"{len(EXAMPLE_FLASH)} shapes (hd 128 at 4 heads; reduced gemma2-2b's hd 64, "
                    f"window 64, softcap 50) f32: max abs err {worst:.3g} "
                    f"(atol {F32_ATOL})")


class FlexSoftcap:
    """One PyTorch call that computes flash's function with a logit softcap,
    which SDPA does not take: ``flex_attention`` compiled, ``cap * tanh(s /
    cap)`` its score_mod, the causal mask within a window its block mask,
    GQA by ``enable_gqa``.  Timed beside flash, used nowhere in the port.
    The window is a tensor the mask reads (T for none: causal then keeps
    every key), so one compile serves each window ``at`` sets."""

    def __init__(self, t: int, cap: float, dev):
        from torch.nn.attention.flex_attention import flex_attention
        self.t, self.dev = t, dev
        self.span = span = torch.tensor(t, device=dev)

        def softcap(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap)

        def keep(b, h, qi, ki):
            return (ki <= qi) & (ki > qi - span)
        self.score_mod, self.mask_mod = softcap, keep
        self.compiled = torch.compile(flex_attention, dynamic=False)
        self.block = None

    def at(self, window: int) -> None:
        from torch.nn.attention.flex_attention import create_block_mask
        self.span.fill_(window if window > 0 else self.t)
        self.block = create_block_mask(self.mask_mod, None, None, self.t,
                                       self.t, device=self.dev)

    def __call__(self, q, k, v):
        return self.compiled(q, k, v, score_mod=self.score_mod,
                             block_mask=self.block, enable_gqa=True)


def flash_at_gemma2(dev) -> dict:
    """Flash at gemma2-2b's served prefill (2, 8/4, 4200, 256) f32, causal,
    softcap 50, against its plain version at the local layers' window 4096
    and the global layers' 0; timed at both beside the plain version and
    the library's call (``FlexSoftcap``, held to the plain version too),
    the local call the record ``flash_attention_fwd@gemma2``.  The bound
    counts the (query, key) pairs each mask keeps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (_ref_fwd,
                                                         flash_attention)
    cfg = get_config(GEMMA2[0])
    b, t, cap = GEMMA2[1], GEMMA2[2], cfg.attn_logit_softcap
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(9)
    times, library = {}, FlexSoftcap(t, cap, dev)
    with torch.no_grad():
        q, k, v = _qkv(gen, dev, b, h, hkv, t, hd, torch.float32, True)
        for window in (cfg.sliding_window, 0):
            err = (flash_attention(q, k, v, True, window, cap)
                   - _ref_fwd(q, k, v, True, window, cap)).abs().max().item()
            if not err <= F32_ATOL:
                raise AssertionError(f"flash at gemma2-2b's prefill, window "
                                     f"{window}: max abs err {err:.3g} > "
                                     f"{F32_ATOL}")
            flops = 4 * b * h * hd * live_pairs(t, True, window)
            nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
            t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t0 = time.perf_counter()
            library.at(window)
            got = library(q, k, v)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            library_err = (got - _ref_fwd(q, k, v, True, window, cap)
                           ).abs().max().item()
            del got
            if not library_err <= F32_ATOL:
                raise AssertionError(f"flex_attention at gemma2-2b's prefill,"
                                     f" window {window}: max abs err "
                                     f"{library_err:.3g} > {F32_ATOL}")
            warm_up(lambda: flash_attention(q, k, v, True, window, cap))
            times[window] = dict(
                max_abs_err=err, library_err=library_err, build_s=build_s,
                library_ms=cuda_ms(lambda: library(q, k, v), 20),
                ms=cuda_ms(lambda: flash_attention(q, k, v, True, window,
                                                   cap), 20),
                plain_ms=cuda_ms(lambda: _ref_fwd(q, k, v, True, window,
                                                  cap), 5),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                pairs=live_pairs(t, True, window))
            r = times[window]
            r["tflops"] = flops / r["ms"] / 1e9
            say("examples", f"flash_attention_fwd at gemma2-2b's prefill "
                            f"(B={b}, H={h}/{hkv}, T={t}, hd={hd}, causal, "
                            f"window {window}, softcap {cap:g}) f32: max abs "
                            f"err {err:.3g} (atol {F32_ATOL}); {r['ms']:.4f} "
                            f"ms = {r['tflops']:.2f} TFLOP/s = "
                            f"{100 * r['bound_ms'] / r['ms']:.1f}% of its "
                            f"bound {r['bound_ms']:.4f} by {r['bound_by']} "
                            f"({r['pairs']:,} pairs); plain "
                            f"{r['plain_ms']:.4f} ms; library (flex_attention"
                            f" compiled, softcap score_mod; SDPA takes none) "
                            f"{r['library_ms']:.4f} ms, max abs err "
                            f"{r['library_err']:.3g}, built in "
                            f"{r['build_s']:.1f} s")
    local, full = times[cfg.sliding_window], times[0]
    rec = {k: local[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "tflops")}
    rec.update(max_abs_err=max(local["max_abs_err"], full["max_abs_err"]),
               library_ms=local["library_ms"], global_ms=full["ms"],
               global_plain_ms=full["plain_ms"],
               global_bound_ms=full["bound_ms"],
               global_library_ms=full["library_ms"])
    return rec


def hybrid_depths() -> None:
    """Full-width recurrentgemma-2b cut to each depth of ``HYBRID_DRAWS``
    on the card (phase hybrid's config: batch 2 x seq 1024, AdamW 3e-4),
    from the port's draw of the entry's seed on the host: the draw's
    SHA-256 and the losses held against the CPU's run from it.  Prints
    where each trajectory rises."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import RuntimeConfig, build_runtime

    def rises(losses):
        return [i + 1 for i in range(1, len(losses))
                if losses[i] > losses[i - 1]]
    for (layers, seed), (want_sha, want) in HYBRID_DRAWS.items():
        config = RuntimeConfig(**HYBRID, seed=seed)
        arch = dataclasses.replace(get_config(HYBRID["arch"]),
                                   num_layers=layers)
        drop_group()
        host = build_runtime(config, arch, device="cpu")
        init = host._state["flat_params"]
        sha = examples_support().flats_sha256(init)
        del host
        drop_group()
        rt = build_runtime(config, arch)
        rt._state = rt.trainer.state_from_flats(init)
        del init
        t0 = time.perf_counter()
        losses = rt.fit(len(want))
        secs = time.perf_counter() - t0
        del rt
        drop_group()
        free_cuda()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"hybrid at {layers} layers: {losses}")
        if sha != want_sha:
            raise AssertionError(f"hybrid at {layers} layers, seed {seed}: "
                                 f"torch's CPU generator drew {sha}, not the "
                                 f"state {want_sha} whose CPU losses "
                                 f"HYBRID_DRAWS holds; take them again with "
                                 f"tests/helpers/hybrid_loss_check.py")
        gap = rel_gap(losses, want)
        if not gap <= CARD_CPU_RTOL:
            raise AssertionError(f"hybrid at {layers} layers, seed {seed}: "
                                 f"losses {losses} against the CPU's {want} "
                                 f"from one draw: rel gap {gap:.3g} > "
                                 f"{CARD_CPU_RTOL}")
        say("examples", f"recurrentgemma-2b, first {layers} layers "
                        f"({arch.layer_kinds().count('rglru')} rglru, "
                        f"{arch.layer_kinds().count('local_attn')} "
                        f"local_attn) at full width, seed {seed}, "
                        f"{len(losses)} zero steps on the card ({secs:.1f} "
                        f"s): {losses}; rises at {rises(losses)}; host draw "
                        f"sha256 {sha[:16]} == the CPU run's, whose losses "
                        f"{list(want)} (rises at {rises(want)}) are within "
                        f"{gap:.3g} (rtol {CARD_CPU_RTOL})")


def phase_examples(smi: str) -> tuple:
    """The nine examples on the card at their defaults and at their tests'
    small flags against the CPU, flash at their shapes, then gemma2-2b
    (the serving example's model) served at full width past its window
    and flash at its prefill shape.  Returns the record
    ``flash_attention_fwd@gemma2`` and its launches in the prefill."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    flash_at_the_examples(dev)
    secs = examples_at_their_defaults()
    say("examples", f"seconds an example at its defaults {secs}")
    examples_card_against_cpu()
    hybrid_depths()
    record = flash_at_gemma2(dev)
    free_cuda()
    name, b, p, k = GEMMA2
    launches, run = serve_through_the_launcher(name, smi, (b, p, k),
                                               "examples")
    reckon = reckon_cache_bytes(run["cfg"], b, p, k)
    if reckon["kv"] != GEMMA2_KV_BYTES or launches["flash_attention_fwd"] \
            != run["cfg"].num_layers:
        raise AssertionError(f"gemma2-2b: KV {reckon['kv']} B (want "
                             f"{GEMMA2_KV_BYTES}), prefill launches "
                             f"{launches}")
    del run
    free_cuda()
    say("examples", f"gemma2-2b: KV caches {GEMMA2_KV_BYTES:,} B == 13 x "
                    f"{p + k} + 13 x 4096 slots x 16,384 B; flash "
                    f"{launches['flash_attention_fwd']} in the prefill, none "
                    f"in decode")
    say("examples", f"phase {time.perf_counter() - t0:.1f} s; {smi}")
    return record, launches["flash_attention_fwd"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one extra step of the main path, of each "
                         "ps path, of the hybrid path, of the pipeline, of "
                         "the two MoE paths and of the xLSTM and hubert "
                         "paths, and one extra push of ps-async with "
                         "torch.profiler; time the sLSTM blocks' share of "
                         "an xLSTM step")
    args = ap.parse_args(argv)

    start = time.perf_counter()
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, plan, specs = main_plan_specs()
    walls = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out
    records = timed("kernels", phase_kernels, arch, plan, specs)
    main_run = timed("main", phase_main, args.profile)
    counts = main_run["counts"]
    ps_counts, ps_losses = timed("ps", phase_ps, args.profile)
    timed("dynamic", phase_dynamic, main_run, ps_losses)
    hybrid_counts = timed("hybrid", phase_hybrid, args.profile)
    timed("async", phase_async, args.profile)
    timed("fleet", phase_fleet, smi)
    timed("pipeline", phase_pipeline, args.profile, smi,
          main_run["losses"])
    moe_flash_rec, moe_counts = timed("moe", phase_moe, args.profile, smi)
    mla_launches = timed("mla", phase_mla, smi)
    hubert_flash_rec, family_counts = timed("families", phase_families,
                                            args.profile, smi)
    serve_records, serve_counts = timed("serve", phase_serve, smi)
    timed("verify", phase_verify, smi)
    timed("configs", phase_configs)
    loop_run_ = timed("loop", phase_loop, smi)
    timed("structure", phase_structure)
    gemma2_record, gemma2_launches = timed("examples", phase_examples, smi)
    say("time", f"phase wall seconds {walls}; "
                f"{time.perf_counter() - start:.1f} s since the start")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()

    # launches: each kernel's count on the path that runs it (the ZeRO
    # step, the int8 push, the top-k push, the hybrid step), read right
    # after that path; phase dynamic asserts its own
    for scheme, names in PS_SCHEMES:
        for name in names:
            counts[name] = ps_counts[scheme][name]
    for name in ("rglru_scan", "rglru_scan_bwd"):
        counts[name] = hybrid_counts[name]
    counts["flash_attention_fwd@hd256"] = \
        hybrid_counts["flash_attention_fwd"]
    # the MoE path's ZeRO step: flash at GQA 16/8 a record of its own, the
    # bucket copies' launches beside the main path's
    records["flash_attention_fwd@moe"] = moe_flash_rec
    counts["flash_attention_fwd@moe"] = moe_counts["flash_attention_fwd"]
    for name in ("bucket_pack", "bucket_unpack"):
        records[name]["moe_launches"] = moe_counts[name]
    # the families' ZeRO steps: hubert's flash (hd 80, non-causal) a record
    # of its own; the bucket copies' launches on both paths
    records["flash_attention_fwd@hubert"] = hubert_flash_rec
    counts["flash_attention_fwd@hubert"] = \
        family_counts["hubert"]["flash_attention_fwd"]
    for path, path_counts in family_counts.items():
        for name in ("bucket_pack", "bucket_unpack"):
            records[name][f"{path}_launches"] = path_counts[name]
    # the served prefills: flash at granite-3-2b's (B = 4) and the scan at
    # recurrentgemma-2b's (T = 2100), records of their own
    records.update(serve_records)
    counts.update(serve_counts)
    # this slice's paths: TrainLoop's 3 steps, the stacked recurrentgemma
    # forward (the stacked granite step's launches are asserted per
    # variant in phase loop)
    records["flash_attention_fwd"]["loop_launches"] = loop_run_["flash"]
    records["flash_attention_fwd@hd256"]["loop_launches"] = \
        loop_run_["hybrid"]["flash_attention_fwd"]
    records["rglru_scan"]["loop_launches"] = \
        loop_run_["hybrid"]["rglru_scan"]
    # gemma2-2b's served prefill: flash with softcap 50 at hd 256, a
    # record of its own
    records["flash_attention_fwd@gemma2"] = gemma2_record
    counts["flash_attention_fwd@gemma2"] = gemma2_launches
    # latent attention's 192 / 128 template: its launches on the cut
    # Moonlight's ZeRO step (phase mla)
    counts["flash_attention_fwd@mla"] = mla_launches
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    **records[name]) for name in REPLACES]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
