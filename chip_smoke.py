"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # needs one CUDA card

Phases, one line (or a few) each:
  1. environment: torch/CUDA versions, the card's name and power limit
     (``nvidia-smi``), and the build of every kernel from the checkout's
     sources (one ``nvcc`` per CUDA source -- qn_apply, flash_attention,
     rmsnorm -- all started together); each kernel's registers, shared
     memory and spills (``-Xptxas -v``; no instance of the bf16 attention
     kernels or of rmsnorm may spill, ``check_spills``); the attention
     library's SASS
     (``cuobjdump``), where the bf16 prefill kernels must hold HMMA (tensor
     cores), LDGSTS (cp.async) and LDSM (ldmatrix);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the serving and training paths give it (qN ring m=8, B=4,
     D=S*2304 for S in {1, 256}, bf16: broyden_step, qn_apply_multi with
     (False,), (False, True) and the SHINE backward's (True,), qn_apply,
     lowrank_append; the same checks, untimed, at the xLSTM DEQ drain's
     rings, D=S*2048 at (S, B) (1, 4), (64, 2), (128, 2) (``XLSTM_QN``),
     and at the HuBERT-XLarge DEQ step's, D=1000*1280, B=4
     (``AUDIO_QN``);
     attention B=4, S=256, 36 heads x 64; decode over a
     1024-token cache with mixed lengths; rmsnorm at ``RMS_SHAPES``, bf16
     and f32, each bf16 shape timed in turns against ``F.rms_norm``): max
     error
     against the stated tolerance, the kernel's time (CUDA events and
     profiler device time per kernel; the qN ops and rmsnorm each after a
     256 MB write that leaves the L2 cold, as the byte bound counts it,
     and back to back beside it), the
     plain version's, and the library call's (events and device time, like
     for like with the kernel's); the qN cases (``QN_CASES``: both
     schedules, m 1/8/30, ragged D, straddling slices, K 1/2/4, refused and
     inactive rows, two calls bit for bit); the qN library's SASS and
     spills (``check_qn_sass``); then the
     attention edge cases (``PREFILL_CASES``, ``DECODE_CASES``: GQA groups
     1/3/4, ragged S and T, kv_length 0 and inside a tile or at the split
     chunk's edges, head dims 16, 64, 80, 96, 128 and 192 in bf16 and
     f32), each through ``check_attention``, and each head dim past 64 at
     its config's heads (``ATTN_HEAD_DIMS``; 192 is DeepSeek-V2-Lite's MLA,
     qk 128 + 64 with v padded; 80 also at Zamba2's prefill S 300 and 512
     and its decode over T 512, and at HuBERT-XLarge's non-causal encoder,
     B=4 S=T=1000 16 heads; 128 also at Pixtral-12B's image prompt, B=2
     S=T=1152 32/8 heads, and its decode over T 2048) timed cold and warm
     beside SDPA and the bound
     (``kernel_attention_head_dims``); then the gradients of
     the attention and rmsnorm
     autograd wrappers (kernel forward, plain recompute backward) against
     plain autograd at the training shapes (``GRAD_ATTN_SHAPES``: head dims
     64, 192 and 80); and ``qn_apply_multi`` at the
     adjoint-Broyden path's shape (f32 ring, m=8, B=4, D=256x2304, the
     mixed pair (False, True) and (True,); ``kernel_qn_adjoint``); and
     both qN kernels at the prefill shape with a warm ring as a prefix
     wave gives it (``PREFILL_WARM``: counts 0, 3, 8, 8, two rows zero
     past position 128); and both at the MDEQ path's ring (``MDEQ_QN``:
     m=18, B=128, D=36864, f32 state, bf16 ring; the case checks, then
     timed cold and warm on a full ring; ``kernel_qn_mdeq``);
  3. end-to-end checks at a small size, card against CPU: the smoke config
     in f32 served (same tokens, matching logits) and trained for three
     steps (same solver steps, matching loss and grad norm), the training
     once with each forward solver (Broyden, adjoint Broyden, Anderson,
     Picard; ``shine_fallback`` backward) and the serving also with
     Anderson; then serving and training at the head dims of the other
     registered configs (80, 96, 128; 2 heads) with the same tokens and
     solver steps on both;
  4. one drain at the full width of each other registered config
     (StableLM-3B, Phi-3-mini, InternLM2-20B; ``phase_serve_configs``:
     2 requests of 128 tokens, 4 new tokens each); then serving at the full
     width of MiniCPM-2B (DEQ, random weights with the weight-tied blocks
     scaled by 0.3): 8 requests, 4 slots, prompts of 128 and 256 tokens, 16
     new tokens each, a 1024-token cache -- through ``ServeLoop``, with the
     kernel launch counts reset just before and read just after; every
     kernel of the path must have launched; then the async pipeline and
     the prefix caches at the same width (``phase_serve_prefix``, solves
     stopped at a relative residual of 1e-2, above the ~2.5e-3 where a
     bf16 solve levels off, ``residual_floor``): 12
     requests (four 128-token bases, each alone, repeated, and with a
     128-token suffix) through (a) the sync loop, (b) the sync loop with
     the host prefix index, (c) the async pipeline (depth 2) with the
     device prefix store and (d) as (c) with admission reordering: every
     request served in full; c and d give b's tokens and c b's step
     sequences; b and c hit >= 4 times, save iterations and spend fewer
     prefill iterations than a; c launches every serve-path kernel, a
     prefill-shaped ``broyden_step`` with a warm ring among them, counts
     no blocking read, and waits on the card only for the solver's reads
     and one clock wait (``count_syncs``, ``async_expected_syncs``); then
     b and c again without record mode, timed in turns (``prefix_timing``);
  5. a profiled window at full width (torch.profiler: device busy time,
     idle share, top kernels) for one prefill tick and one decode tick;
  6. training at the full width of MiniCPM-2B (the same weights, DEQ with
     the ``DEQSettings`` defaults, SHINE-fallback backward): 4 AdamW steps
     of batch 4 x 256 synthetic tokens through ``Trainer``, launch counts
     reset just before and read just after, metrics on, and no host wait
     besides the solver's two reads per iteration and the one metrics read
     per step (``count_syncs``, ``expected_syncs``), nor with metrics off
     (one more step); then one profiled train step,
     and the same 4 steps with the attention forward through its plain
     version: the same forward steps and fallback rows and losses within
     rtol 1e-2; then the plain-attention arm once more with each forward
     solve answered by the kernel arm's result, so that both take their
     gradients at the same iterates: the same again, and grad norms within
     5e-2 (the two round the attention probabilities to bf16 at different
     points; a wrong attention kernel moves them far more;
     ``hold_trajectory``); the kernel arm runs twice, bit for bit;
  7. a refine backward (``shine_refine``) with a carried ring
     (``deq_carry="full"``) at full width: the backward's adjoint solve
     must leave the carry's ring bit for bit as the forward left it; and a
     train step with ``deq_carry="full"`` (solver guard off) that
     ``skip_nonfinite`` rejects must give back the pre-step carry bit for
     bit;
  8. 2 AdamW steps at full width with adjoint Broyden and with Anderson
     as the forward solver (``phase_train_solvers``): finite losses, the
     adjoint arm's ``qn_apply_multi`` launches, no off-path launch, each
     arm's step time, statuses, peak memory and one profiled step; then
     the same 2 steps with span tracing on (``--trace-out``'s path): the
     trace's ``forward_solve``, ``implicit_backward`` and ``optimizer``
     phases, ended by CUDA events, must tile each ``train_step`` span
     (``check_trace_phases``), and the traced steps (metrics off) must make
     as many host waits as the untraced ones (metrics on): the solver's and
     the trainer's, nothing more (``count_syncs``);
  9. fault injection at the full width of MiniCPM-2B (``phase_chaos``,
     after step 4): through ``lm.prefill`` at B=4 x 256 (the qN kernels'
     streaming schedule, slices straddling samples) and B=4 x 1 (the
     resident one), a ``nonfinite`` and a ``diverge`` fault at row 1 from
     step 2 and a warm carry with a NaN ring row 2: the faulted row ends
     with its class's status and a finite best iterate, every other row's
     iterate and logits bit for bit the fault-free run's; a poisoned
     device prefix store slot in the async pipeline: the seeded request is
     retried cold and evicted as poisoned, the others' tokens are an
     unpoisoned drain's; and a prefill before ``faultinject`` is imported
     and after it was armed and disarmed: the same iterate, launches and
     host waits;
 10. the multiscale DEQ at ``MDEQConfig()`` (``phase_mdeq``): batch 128 of
     ``synthetic_cifar``, a forward held to the solver's host reads, 8 SGD
     steps with ``shine_fallback`` whose loss must fall (both qN kernels
     launched, counts reset and read), the cosine of the ``full`` and
     ``shine_fallback`` gradients above 0.5, and a small config card
     against CPU (same steps, logits within 1e-4 of their scale);
 11. HOAG on a logistic regression at real-sim's 20,958 features
     (``phase_bilevel``; 5000 / 1000 / 1000 samples): the step-0
     hypergradient by SHINE within 0.5 of CG's, then 8 outer steps of
     ``full_cg``, ``shine``, ``shine_opa`` and ``jfb``: the validation loss
     falls, the shine modes make no backward HVP, and the host waits are
     exactly the L-BFGS, line-search and CG stop tests and three record
     reads an outer step (``hoag_expected_syncs``);
 12. the layer stack with MLA and the fine-grained MoE (``phase_moe``):
     DeepSeek-V2-Lite at its published widths and full depth (27 layers,
     bf16, random weights from seed 0, no DEQ): 4 requests of 128/256 tokens over 4 slots, 16 new tokens, a 512-token
     cache, a sync drain and an async drain (logits recorded: every
     request served, finite logits; the async tokens the sync ones bit for
     bit; the async drain's only host wait the clock wait) and an async
     drain unrecorded for the rate, each with the launch counts reset
     just before and read just after (both attention kernels and rmsnorm
     must launch); a profiled prefill tick and decode tick (device busy
     time and idle share); prefill over 128 tokens and one decode step
     against a full forward over 129 (``tests/test_archs.py``'s 3e-2 /
     4e-2; at a capacity factor that drops no token) for each token seed
     of ``CACHE_SEEDS``, then at 4 layers in bf16 and in f32 (at
     ``TOL_F32``); a drain of DeepSeekMoE-16B at
     published widths and full depth (28 layers); V2-Lite with the DEQ
     (``DEQSettings`` defaults, 4 tied ``attn_moe`` blocks x0.3): every
     serve-path kernel launches, the solve statuses reported; and both
     MoE configs at smoke size in f32, card against CPU (same tokens,
     logits within 1e-3 of their scale; the MLA config at qk 48 + 16, a
     head dim the kernels instantiate, where the smoke 16 + 8 is not);
 13. the hybrid family (``phase_hybrid``): Zamba2-2.7B at its published
     widths and full depth (54 Mamba2 layers, d 2560, state 64, chunk 256;
     the shared attention + MLP block, 32 x 80 heads, every 6 layers;
     2.42 B parameters), bf16, random weights from seed 0, the layer
     stack: a sync and an async drain of 8 requests (prompt waves of 128,
     256 and 300 tokens) over 4 slots, 16 new tokens, a 512-token cache
     (async = sync tokens bit for bit, one host wait; rmsnorm and both
     attention kernels launch); a profiled prefill and decode tick; the
     cache check at S 128 and 300 for each token seed, held in f32 at
     full depth (``TOL_F32``) and reported in bf16 beside the forward's
     own rounding floor (the same rows forwarded at batch 1 and 2), which
     at this depth already exceeds the reference's 3e-2 / 4e-2; one
     layer's chunked SSD against the sequential ``mamba2_scan_ref`` at S
     300; 4 AdamW steps at 4 x 512 with ``remat="full"`` (step ms, peak
     memory, launches held to one forward's plus one recompute of every
     unit: ``_forward_launches``) and a non-zero gradient in the shared
     block; an async drain of the DEQ form (4 tied ``zamba_unit``s, tied
     weights x0.3; every serve-path kernel launches, solve steps and
     statuses reported); the smoke config card against CPU in f32 (a
     drain, 3 train steps);
 14. the SSM family (``phase_xlstm``): xLSTM-1.3B at its published widths
     and full depth (42 mLSTM and 6 sLSTM layers, d 2048, 4 heads, mLSTM
     inner 4096 in heads of 1024, chunk 256; 2.02 B parameters), bf16,
     random weights from seed 0, the layer stack, no attention: the drains,
     profiled ticks and cache check of step 13 (rmsnorm launches, neither
     attention kernel does); the chunked mLSTM cell (at unit-scale inputs)
     and unit 0's hoisted sLSTM against their sequential oracles in f32 at
     S 300; 4 AdamW steps at 4 x 512 with ``remat="full"`` (launches held
     to ``_forward_launches``), after which the caller's weights are bit
     for bit as they were, and one traced at 4 x 64; an
     async drain of the DEQ form (4 tied ``xlstm_unit``s x0.3, prompts of
     64 and 128 tokens; both qN kernels launch); the smoke config card
     against CPU in f32 (a drain, 3 train steps);
 15. training the layer stack (``phase_train_stack``): DeepSeek-V2-Lite
     and DeepSeekMoE-16B at full width cut to 4 layers, 3 AdamW steps of 4
     x 256 with ``remat="full"`` and again with ``"none"`` from the same
     weights, held at ``hold_trajectory``'s tolerances; peak memory and
     launches of both, each train run's peak printed beside the one
     measured when AdamW still built a second copy of the state;
 16. the audio and vlm families (``phase_audio_vlm``), bf16, random
     weights from seed 0, published widths: HuBERT-XLarge at full depth
     (48 layers, d 1280, 16 x 80 heads not causal, GELU ff 5120, 504
     classes; 0.95 B parameters), 3 AdamW steps of the layer stack at 4 x
     1000 stub frames with ``remat="full"`` (launches held to
     ``_forward_launches``, no decode launch) and a profiled step, then 2
     steps of its DEQ form (4 tied ``attn_mlp`` blocks x0.3: both qN
     kernels and the non-causal prefill kernel launch; solve steps and
     statuses); Pixtral-12B at full depth (40 layers, d 5120, 32/8 x 128,
     ff 14336, vocab 131072; 12.25 B parameters): a sync and an async
     drain of 8 text requests (128 and 256 tokens) over 4 slots with a
     2048-token cache (async = sync bit for bit, one host wait), the
     cache check with its 1024 image tokens (prefill over images + 128
     tokens and one decode step against a forward; bf16 reported beside
     its rounding floor, f32 held at ``TOL_F32``), and 2 AdamW steps at
     full width cut to 6 layers over 2 x (1024 image + 512 text) with the
     attention kernel and again with the chunked ``flash_xla`` path
     (``hold_trajectory``; both peaks); the smoke configs card against CPU
     in f32 (HuBERT's layer stack and DEQ train steps, a Pixtral drain and
     train steps with images); an ``audio_vlm_phase_split`` line;
 17. layout and costing on one card (``phase_layout``, run after steps 18
     and 19, last): the dry-run's
     whole matrix (``python -m repro_torch.launch.dryrun --all``, started
     in a niced subprocess when the script starts and collected here; the
     ``single`` and ``multi`` cells run the sharded step on fake worlds of
     256 and 512 ranks, those in ``DRYRUN_EXCLUDE`` left to the CLI) with
     0 failures, one line with its cells, skips, failures and seconds;
     then, against the caching allocator (``memory_allocated``, each leaf
     rounded to its 512-byte block): the parameters of all ten configs at
     full width, the MiniCPM-2B DEQ train state at 4 x 256 and the caches
     of the drains of steps 4 and 12-16 (``LAYOUT_DRAINS``), each equal
     to the dry-run's bytes on ``one``; then two real steps that run the
     kernels, the MiniCPM-2B DEQ train step and the DeepSeek-V2-Lite
     prefill at 4 x 256: their peak (``max_memory_allocated``) within
     ``LAYOUT_PEAK_TOL`` of the dry-run's ``argument_bytes + temp_bytes``,
     and the dry-run's FLOP count over the median event time of 3 runs
     (the DEQ's at the solve's own step count) as TFLOP/s and a share of
     the card's dense bf16 peak, held in (0, 1.05];
 18. sharded execution (``phase_sharded``): a world of one rank over
     NCCL, mesh (data=1, model=1), the MiniCPM-2B DEQ train step at full
     width, 4 x 256, ZeRO-1, through the sharded code (DTensor parameters,
     ``local_map`` kernel routes, the batch-split solve, the clip over the
     whole gradient), against the unsharded step (every parameter bit for
     bit, every first moment at rtol 1e-4; ``sharded_train_step``), each
     arm's step profiled (device busy time, idle share); the serving arms
     of ``SHARDED_ARMS`` under ``DECODE_RULES`` / ``PREFILL_RULES`` (the
     decode over the length-split cache: the split launch, the gathered
     partials, the combine launch; sync, sync + host index, async at depth
     2, async + device store; ``sharded_serve_arms``) each against the
     same arm unsharded (tokens bit for bit, the same hits, prefill steps
     and iterations, the async arms' host waits the solver's reads and one
     clock wait; ``check_mesh_arm``), each profiled; the step again with
     ``grad_accum`` 2, held as the first; the seconds of each part
     (``sharded_phase_split``); the five path kernels' launches
     counted over all, every one launched by the serving arms;
     ``CommDebugMode``'s collectives of each, those of the first step held
     against the dry-run's count of the same step on a fake world of the
     same mesh (``sharded_step_dryrun``, started in a niced subprocess
     when the script starts: kinds and counts equal at (1, 1),
     ``check_issued``); the five
     kernels at the local shapes of a (2, 2) mesh against their plain
     versions, and two 512-key slices' decode partials (slices with no
     valid key among them) combined against the whole-cache decode; with
     four cards, four ranks at (2, 2) (the DEQ step, alone and with
     ``grad_accum`` 2, against the unsharded step at the reference's
     tolerances, its first moments within ``MU_REL_L2_SHARDED`` a leaf,
     the first step's collectives (kinds, counts and link bytes) equal to
     the dry-run's and each rank's peak within ``LAYOUT_PEAK_TOL`` of its
     ``argument_bytes + temp_bytes``, each one's second step timed, the
     sync drain and the async drain with
     the device store against the unsharded drains' tokens,
     DeepSeek-V2-Lite's
     prefill through the expert-parallel branch with 0 drops, held in f32
     at 4 layers at ``TOL_SHARDED``, and in bf16 at full depth at
     ``TOL_SHARDED`` or, against an f32 prefill over the same weights,
     within ``EP_FLOOR_MULT`` times the unsharded bf16 prefill's own
     error); with fewer, a line that says so, the same branch on four
     gloo ranks of the host's CPU at the smoke configs
     (``sharded_four_cpu_ranks``: the host's PyTorch at (2, 2), no card,
     no time; the collectives held as on four cards), and that unsharded
     bf16 error read on the one card;
 19. the examples (``phase_examples``) through their own functions:
     ``examples/torch_quickstart.py``'s three backward modes for 20 steps
     on the card against the same steps on the CPU (losses at rtol 1e-4),
     ``torch_serve_lm.py`` as its CLI runs (the smoke StableLM-3B, and its
     DEQ form) and in f32 card against CPU (the same tokens),
     ``torch_train_deq_lm.py`` for 3 steps at its ~100M width with SHINE;
     each example's path kernels launched (counted from 0 around each),
     and both qN kernels at the examples' rings against their plain
     versions (``EXAMPLE_QN``; the examples' attention and rmsnorm shapes
     are phase 2's ``serve_lm_smoke`` / ``deq_lm_100m`` cases and
     ``RMS_SHAPES``' 2048 x 1024);
 20. a ``{"kernels": [...]}`` line (with each kernel's launches in the
     step 8 arms, in arm c of step 4, in the MDEQ SGD steps, in the
     V2-Lite async drain of step 12, in the Zamba2 async drain and train
     steps of step 13, in the xLSTM async drain and train steps of step
     14, in the HuBERT train and DEQ steps, the Pixtral async drain and
     its kernel-arm train steps of step 16, in step 18's sharded
     steps and serving arms and in step 19's examples), then the last
     line ``{"ok": true,
     "device": {...}}``.

Any failed phase raises and the script exits non-zero without the last
line.  It imports nothing of JAX; it needs the repository's ``src/`` beside
it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.mdeq_cifar import MDEQConfig  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.core import bilevel  # noqa: E402
from repro_torch.core import solvers as core_solvers  # noqa: E402
from repro_torch.core.deq import DEQConfig  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    SyntheticTokenDataset,
    make_lm_batch_iterator,
    stub_batch,
)
from repro_torch.kernels import build, launches, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as cuda_fa  # noqa: E402
from repro_torch.kernels import qn_apply as cuda_qn  # noqa: E402
from repro_torch.kernels import rmsnorm as cuda_rms  # noqa: E402
from repro_torch.implicit import ImplicitConfig  # noqa: E402
from repro_torch.implicit import fixed_point as implicit_fp  # noqa: E402
from repro_torch.implicit import solvers as implicit_solvers  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch.mesh import ONE_CARD, MeshSpec  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.shapes import ShapeSuite  # noqa: E402
from repro_torch.parallel.sharding import ShardCtx  # noqa: E402
from repro_torch.models import lm, mdeq  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import tracing as obs_tracing  # noqa: E402
from repro_torch.runtime.serving import (  # noqa: E402
    Request, ServeLoop, cache_batch_axes, serve_summary)
from repro_torch.runtime.trainer import Trainer  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by operand type
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# kernel -> (route, source, TPU kernel it replaces)
KERNELS = {
    "broyden_step": ("cuda", "src/repro_torch/csrc/qn_apply.cu",
                     "src/repro/kernels/qn_apply.py:481"),
    "qn_apply_multi": ("cuda", "src/repro_torch/csrc/qn_apply.cu",
                       "src/repro/kernels/qn_apply.py:244"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:95"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:160"),
    "rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:26"),
    "lowrank_append": ("cuda", "src/repro_torch/csrc/qn_apply.cu",
                       "src/repro/kernels/qn_apply.py:343"),
    "qn_apply": ("cuda", "src/repro_torch/csrc/qn_apply.cu",
                 "src/repro/kernels/qn_apply.py:119"),
}
# kernels that no path of either package launches (only the ops and the
# LowRank methods reach them); checked in phase 2, 0 launches on every path
OFF_PATH = ("lowrank_append", "qn_apply")
SERVE_PATH = ("broyden_step", "qn_apply_multi", "flash_attention",
              "decode_attention", "rmsnorm")
TRAIN_PATH = ("broyden_step", "qn_apply_multi", "flash_attention", "rmsnorm")

# tolerances, applied elementwise as |got - want| <= atol + rtol * |want|:
# f32 outputs accumulate in another order than the plain version (the qN
# outputs, sums of ~1e6 products that may cancel, take an atol scaled to
# each row's largest entry: row_tol); bf16
# outputs may differ by a bf16 rounding (2^-8 relative) of the output, and
# prefill attention also by the plain version's bf16 rounding of the
# probabilities (up to ~1.6e-2 at outputs near 0, over values up to ~4).
# Decode outputs are averages over >= 129 keys (|out| <= ~0.5), so decode
# takes a small atol: one key let in past kv_length moves them by ~1e-1,
# which phase 2 checks that the tolerance sees.
TOL_F32 = dict(rtol=1e-3, atol=1e-3)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
TOL_DECODE = dict(rtol=2e-2, atol=5e-3)


def say(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=str), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 10, tries: int = 10, exclude: str = "",
                   with_calls: bool = False):
    """Device time per call of each kernel ``fn`` launches (its profiler
    self time over ``iters`` calls), keyed by the kernel's short name;
    kernels whose name holds ``exclude`` are left out.  With
    ``with_calls``, also each kernel's launches per call.  A trace that
    holds fewer kernels than calls lost events (seen at the short rmsnorm
    kernels, some traces holding 7-9 of 10, six in a row once): it is
    reported (``profiler_retry``, what it held) and taken again, up to
    ``tries`` times, then the run fails; an incomplete trace is never
    used."""
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    seen = []
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == cuda
                and not (exclude and exclude in e.key)]
        name = {e.key: re.sub(r"^void |\(anonymous namespace\)::", "",
                              e.key).split("(")[0] for e in kern}
        if sum(e.count for e in kern) >= iters:
            ms = {name[e.key]: e.self_device_time_total / 1e3 / iters
                  for e in kern}
            if not with_calls:
                return ms
            return ms, {name[e.key]: e.count / iters for e in kern}
        seen.append({name[e.key]: e.count for e in kern})
        say("profiler_retry", calls=iters, traced=seen[-1])
    raise RuntimeError(f"profiler traced fewer than {iters} kernels in "
                       f"{tries} tries: {seen}")


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call: the summed self time of every kernel ``fn``
    launches (excludes the wrapper's host work, which CUDA-event timing of
    back-to-back calls includes when the host is slower than the kernel)."""
    return sum(device_profile(fn, iters).values())


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def excess(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """Largest ``|got - want| - (atol + rtol * |want|)``: > 0 is a miss."""
    g, w = got.float(), want.float()
    return ((g - w).abs() - (tol["atol"] + tol["rtol"] * w.abs())
            ).max().item()


def row_tol(want: torch.Tensor, rtol: float, rel_atol: float) -> dict:
    """``rtol`` plus an atol of ``rel_atol`` times each row's largest
    entry: a sum of many products carries a rounding error in proportion
    to its terms, which a cancelling entry does not show."""
    return dict(rtol=rtol,
                atol=rel_atol * want.float().abs().amax(-1, keepdim=True))


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                tol: dict) -> float:
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs().max().item()
    if excess(g, w, tol) > 0:
        atol = float(torch.as_tensor(tol["atol"]).max())
        raise AssertionError(f"{name}: max |err| {err:.3e} exceeds "
                             f"rtol {tol['rtol']}, atol (max) {atol:.3e}")
    return err


def _check_evicted(name, ev_u, ev_v, w_evu, w_evv, u, v, slot) -> None:
    """The evicted rows are copies of the ring's old slot rows: equal to
    the plain version's and to the ring before the op, bit for bit."""
    rows = torch.arange(u.shape[1], device=u.device)
    for nm, g_ev, w_ev, ring in (("ev_u", ev_u, w_evu, u),
                                 ("ev_v", ev_v, w_evv, v)):
        old = ring[slot.long(), rows]
        if not (torch.equal(g_ev, w_ev) and torch.equal(g_ev, old)):
            raise AssertionError(f"{name}.{nm}: not the old slot rows")


def _check_slot_write(name, new_u, new_v, w_u, w_v, u, v, hot) -> float:
    """Every ring row the op does not write (``~hot``) must equal the ring
    before it, bit for bit, in the kernel's output and the plain
    version's; each written slot row holds at rtol 2e-2 plus 2e-3 x its
    own largest entry (one bf16 rounding)."""
    if not hot.any():
        raise AssertionError(f"{name}: the inputs write no ring row")
    err = 0.0
    for nm, g_r, w_r, ring in (("new_u", new_u, w_u, u),
                               ("new_v", new_v, w_v, v)):
        if not (torch.equal(g_r[~hot], ring[~hot])
                and torch.equal(w_r[~hot], ring[~hot])):
            raise AssertionError(f"{name}.{nm}: a row the op does not "
                                 "write changed")
        w_hot = w_r[hot]
        err = max(err, check_close(f"{name}.{nm}[slot]", g_r[hot], w_hot,
                                   row_tol(w_hot, 2e-2, 2e-3)))
    return err


def _hot(u, slot, write) -> torch.Tensor:
    hot = torch.zeros(u.shape[:2], dtype=torch.bool, device=u.device)
    hot[slot.long(), torch.arange(u.shape[1], device=u.device)] = write
    return hot


def check_broyden_step(name: str, got, want, u, v, slot, active,
                       eps: float) -> float:
    """Hold ``broyden_step``'s outputs against the plain version's: the
    evicted rows and the unwritten ring rows bit for bit, the written slot
    rows at the bf16 tolerance (``_check_slot_write``); ``hg_new`` and
    ``b`` at rtol 1e-3 with atol 1e-4 of each row's largest entry, and
    ``den`` at the f32 tolerance.  ``u``/``v`` are the ring before the
    step."""
    new_u, new_v, hg, b, den, ev_u, ev_v = got
    w_u, w_v, w_hg, w_b, w_den, w_evu, w_evv = want
    _check_evicted(name, ev_u, ev_v, w_evu, w_evv, u, v, slot)
    err = _check_slot_write(name, new_u, new_v, w_u, w_v, u, v,
                            _hot(u, slot, active & (w_den.abs() > eps)))
    for nm, g_o, w_o in (("hg_new", hg, w_hg), ("b", b, w_b)):
        err = max(err, check_close(f"{name}.{nm}", g_o, w_o,
                                   row_tol(w_o, 1e-3, 1e-4)))
    err = max(err, check_close(f"{name}.den", den, w_den, TOL_F32))
    return err


def check_lowrank_append(name: str, got, want, u, v, slot, upd) -> float:
    """Hold ``lowrank_append``'s outputs against the plain version's as
    ``broyden_step``'s ring outputs are held.  ``u``/``v`` are the ring
    before the write."""
    new_u, new_v, ev_u, ev_v = got
    w_u, w_v, w_evu, w_evv = want
    _check_evicted(name, ev_u, ev_v, w_evu, w_evv, u, v, slot)
    return _check_slot_write(name, new_u, new_v, w_u, w_v, u, v,
                             _hot(u, slot, upd > 0.5))


def check_attention(name: str, got, want, q, k, v, kv_length,
                    tol: dict) -> float:
    """Hold an attention output -- prefill ``(B, S, H, hd)`` or decode
    ``(B, H, hd)`` -- against the plain version's at ``tol``, and each row
    whose ``kv_length`` is 0 (every key masked) also against the uniform
    average of its kv head's T values, computed here from ``v`` alone."""
    err = check_close(name, got, want, tol)
    if kv_length is None:
        return err
    zero = (torch.as_tensor(kv_length) < 1).nonzero().flatten().tolist()
    if zero:
        mean = v.float().mean(1).repeat_interleave(q.shape[-2] // v.shape[2],
                                                   dim=1)  # (B, H, hd)
        for b in zero:
            g = got[b].float()
            err = max(err, check_close(f"{name}[kv_length 0, row {b}]", g,
                                       mean[b].expand_as(g), tol))
    return err


def check_grads(name: str, got, want) -> float:
    """Gradients of an autograd wrapper (kernel forward, backward by
    recomputing the plain version from the saved inputs) against autograd
    straight through the plain version.  The backward is the same
    computation on the same inputs, so the two agree to the last bit in
    practice; each is held at rtol 2e-2 plus 2e-3 x its largest entry
    (one bf16 rounding), far inside what a wrong or missing gradient
    gives."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = max(err, check_close(f"{name}.grad[{i}]", g, w,
                                   dict(rtol=2e-2, atol=2e-3 * w.float()
                                        .abs().max())))
    return err


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------


def short_kernel(sym: str) -> str:
    """``name<int args>`` of a mangled kernel symbol in a namespace (the
    sources' anonymous one: ``_ZN<len><ns><len><name>I...E``), else the
    symbol itself."""
    m = re.match(r"_ZN(\d+)", sym)
    m = m and re.compile(r"(\d+)").match(sym, m.end() + int(m.group(1)))
    if not m:
        return sym
    n = int(m.group(1))
    name = sym[m.end():m.end() + n]
    args = re.findall(r"Li(\d+)E", sym[m.end() + n:].split("Ev", 1)[0])
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_summary(log: str) -> dict:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its ``Used ...`` line
    (registers, shared memory) and its spill line."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = short_kernel(m.group(1))
            while cur in out:
                cur += "'"
            out[cur] = {}
        elif cur and "spill stores" in ln:
            out[cur]["spill"] = ln.strip()
        elif cur and "Used" in ln and "registers" in ln:
            out[cur]["used"] = ln.split(":", 1)[1].strip()
    return out


SASS_OPS = ("HMMA", "LDGSTS", "LDSM", "FFMA")


def sass_text(lib) -> str:
    """``cuobjdump -sass`` of a built library."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_ops(text: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing, its instructions in
    order (predicates dropped)."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = short_kernel(m.group(1))
            out[cur] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if cur is not None and ins:
            out[cur].append(" ".join(w for w in ins.group(1).split()
                                     if not w.startswith("@")))
    return out


def sass_summary(ops: dict) -> dict:
    """Per kernel of ``sass_ops``: the count of each opcode of
    ``SASS_OPS`` and the first such instruction."""
    out = {}
    for name, instrs in ops.items():
        r = out[name] = {"count": dict.fromkeys(SASS_OPS, 0), "first": {}}
        for ins in instrs:
            op = ins.split(".")[0].split()[0] if ins else ""
            if op in SASS_OPS:
                r["count"][op] += 1
                r["first"].setdefault(op, ins)
    return out


# the bf16 stream kernels at the paths' ring memory (M = 8), 16-byte path
QN_SASS_KERNELS = ("qn_kernel<1,8,1,1>", "qn_kernel<1,8,4,1>",
                   "broyden_kernel<1,8,1>")
WIDE_LOADS = ("LDG.E.128", "LDGSTS.E.BYPASS.128", "UBLKCP")


def _wide(op: str) -> bool:
    """A 16-byte global load: one of WIDE_LOADS, cache modifiers allowed
    (``LDGSTS.E.BYPASS.LTC128B.128``, ``LDG.E.128.CONSTANT``)."""
    if op.startswith("UBLKCP"):
        return True
    parts = op.split(".")
    return parts[0] in ("LDG", "LDGSTS") and "E" in parts and "128" in parts


def check_qn_sass(ops: dict, ptxas: dict) -> dict:
    """Each of ``QN_SASS_KERNELS`` must load 16 bytes at a time
    (``WIDE_LOADS``), touch no local memory (LDL/STL) and spill nothing
    (its ptxas line: 0 bytes spill stores and loads).  Returns, per kernel,
    the count of wide loads and the first one, and the spill line."""
    out = {}
    for name in QN_SASS_KERNELS:
        if name not in ops:
            raise AssertionError(f"no {name} in the qN library")
        wide = [i for i in ops[name] if _wide(i.split()[0])]
        local = [i for i in ops[name]
                 if i.split()[0].split(".")[0] in ("LDL", "STL")]
        spill = ptxas.get(name, {}).get("spill", "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      spill)
        if not wide:
            raise AssertionError(f"{name}: no 16-byte load in its SASS")
        if local:
            raise AssertionError(f"{name}: local memory: {local[0]}")
        if not m or m.group(1) != "0" or m.group(2) != "0":
            raise AssertionError(f"{name}: ptxas spills: {spill!r}")
        out[name] = {"wide_loads": len(wide), "first": wide[0],
                     "spill": spill}
    return out


def _spill_bytes(line: str) -> int:
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if not m:
        raise AssertionError(f"no spill count in {line!r}")
    return int(m.group(1)) + int(m.group(2))


# the kernels of the bf16 paths, which must not spill: every instance of
# these (the f32 attention body keeps a row in registers and may spill at
# large head dims; it is reported)
NO_SPILL = {"flash_attention": ("flash_fwd_mma_kernel", "decode_split_kernel",
                                "decode_combine_kernel"),
            "rmsnorm": ("rmsnorm_vec_kernel", "rmsnorm_generic_kernel")}


def check_spills(ptxas: dict) -> dict:
    """Spill bytes (stores + loads) of every kernel instance of the
    attention and rmsnorm libraries; raises if an instance of ``NO_SPILL``
    spills."""
    out = {}
    for source, prefixes in NO_SPILL.items():
        for name, r in ptxas[source].items():
            n = out[f"{source}:{name}"] = _spill_bytes(r.get("spill", ""))
            if n and name.startswith(prefixes):
                raise AssertionError(f"{name} spills: {r['spill']!r}")
    return out


def check_attention_sass(sass: dict) -> None:
    """The bf16 prefill kernels must run their products on the tensor cores
    (HMMA), fill their tiles with async copies (LDGSTS) and read fragments
    with ldmatrix (LDSM)."""
    mma = {k: v for k, v in sass.items()
           if k.startswith("flash_fwd_mma_kernel")}
    if not mma:
        raise AssertionError("no flash_fwd_mma_kernel in the library")
    for name, r in mma.items():
        missing = [op for op in ("HMMA", "LDGSTS", "LDSM")
                   if r["count"][op] == 0]
        if missing:
            raise AssertionError(f"{name}: no {missing} in its SASS")


def phase_env() -> dict:
    smi = nvidia_smi_line()
    print(smi, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi)
    t0 = time.perf_counter()
    report = build.build_all()  # one nvcc per source, all started together
    for name in build.SOURCES:
        build.library(name)
    secs = time.perf_counter() - t0
    say("build", seconds=round(secs, 2),
        nvcc={n: r["seconds"] for n, r in report.items()},
        cached=[n for n, r in report.items() if r["cached"]])
    ptxas = {}
    for name, r in report.items():
        ptxas[name] = ptxas_summary(r["log"])
        say("ptxas", source=f"{name}.cu", kernels=ptxas[name])
    say("spills", kernels=check_spills(ptxas))
    qn = check_qn_sass(sass_ops(sass_text(build.library_path(
        "qn_apply"))), ptxas["qn_apply"])
    say("sass", source="qn_apply.cu", kernels=qn)
    sass = sass_summary(sass_ops(sass_text(build.library_path(
        "flash_attention"))))
    check_attention_sass(sass)
    say("sass", source="flash_attention.cu",
        kernels={k: v["count"] for k, v in sass.items()},
        first={k: v["first"] for k, v in sass.items()
               if k.startswith("flash_fwd_mma_kernel")})
    return {"nvidia_smi": smi, "build_seconds": secs}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at the path's shapes
# ---------------------------------------------------------------------------


def _ring(m, bsz, dim, gen, dtype=torch.bfloat16):
    """A ring with O(0.3) entries (as tests/test_torch_cuda.py draws it):
    the low-rank term then dominates ``H x`` and the written rows, so a
    wrong coefficient, slot or row falls far outside the tolerance."""
    dev = "cuda"
    u = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)).to(dtype)
    v = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)).to(dtype)
    count = torch.tensor([m + 3, 3, 5, 0][:bsz], dtype=torch.int32,
                         device=dev)
    mask = (torch.arange(m, device=dev)[:, None]
            < torch.clamp(count, max=m)[None, :]).float()
    return u, v, count, mask


# qN cases besides the paths' shapes: (tag, m, B, D, schedule) -- each run
# in bf16 and f32.  Resident and streaming, m in {1, 8, 30}, a ragged D (not
# a multiple of 8: the scalar path), streaming slices that straddle sample
# boundaries, and B above the co-resident CTAs (one slice per sample, no
# barrier).  Row b of a case takes the b % 5-th of: slot 0, slot m-1, a
# refused append (s = 0, so den = 0), an inactive row with an empty ring,
# and slot 1 % m.
QN_CASES = [
    ("resident_ragged", 8, 5, 1030, "resident"),
    ("resident_m1", 1, 4, 2304, "resident"),
    ("resident_m30", 30, 5, 520, "resident"),
    ("streaming", 8, 4, 40000, "streaming"),
    ("streaming_ragged", 8, 5, 30003, "streaming"),
    ("streaming_m1", 1, 3, 100008, "streaming"),
    ("streaming_m30", 30, 4, 20000, "streaming"),
    ("per_sample", 8, 300, 5000, "streaming"),
]
QN_FLAGS = ((False,), (False, True), (True, False, False, True))


def qn_case_inputs(m, bsz, dim, dtype, gen):
    """``(u, v, mask, slot, active, g, s, hg)`` with the row kinds of
    ``QN_CASES``."""
    u, v, _, _ = _ring(m, bsz, dim, gen, dtype)
    base = [m, m - 1, m + 2, 0, 1]
    count = torch.tensor([base[b % 5] for b in range(bsz)], dtype=torch.int32,
                         device="cuda")
    mask = (torch.arange(m, device="cuda")[:, None]
            < torch.clamp(count, max=m)[None, :]).float()
    slot = (count % m).int()
    active = torch.tensor([b % 5 != 3 for b in range(bsz)], device="cuda")
    g = torch.randn(bsz, dim, device="cuda", generator=gen)
    s = 0.1 * torch.randn(bsz, dim, device="cuda", generator=gen)
    s[2::5] = 0.0  # den = 0: the append is refused
    hg = torch.randn(bsz, dim, device="cuda", generator=gen)
    return u, v, mask, slot, active, g, s, hg


def _straddles(p, bsz, dim) -> bool:
    """Whether some CTA slice of plan ``p`` crosses a sample boundary."""
    return any(f0 // dim != (f1 - 1) // dim
               for f0, f1 in cuda_qn.slices(p, bsz, dim))


# the prefill shape with a warm ring, as a prefix-cache wave gives it: rows
# enter with counts PREFILL_WARM_COUNTS (a miss, a partial ring, two full
# ones) and the rows of PREFILL_WARM_SUFFIX hold zeros past position
# PREFILL_WARM_PREFIX (a partial hit's suffix)
PREFILL_WARM = ("prefill_warm", 8, 4, 256 * 2304)
PREFILL_WARM_COUNTS = (0, 3, 8, 8)
PREFILL_WARM_SUFFIX = (1, 3)
PREFILL_WARM_PREFIX = 128


def qn_prefill_warm_inputs(gen):
    """``qn_case_inputs`` for ``PREFILL_WARM`` (bf16 ring, every row
    active)."""
    _, m, bsz, dim = PREFILL_WARM
    u, v, _, _ = _ring(m, bsz, dim, gen)
    for b in PREFILL_WARM_SUFFIX:
        u[:, b, PREFILL_WARM_PREFIX * 2304:] = 0
        v[:, b, PREFILL_WARM_PREFIX * 2304:] = 0
    count = torch.tensor(PREFILL_WARM_COUNTS, dtype=torch.int32,
                         device="cuda")
    mask = (torch.arange(m, device="cuda")[:, None]
            < torch.clamp(count, max=m)[None, :]).float()
    active = torch.ones(bsz, dtype=torch.bool, device="cuda")
    g = torch.randn(bsz, dim, device="cuda", generator=gen)
    s = 0.1 * torch.randn(bsz, dim, device="cuda", generator=gen)
    hg = torch.randn(bsz, dim, device="cuda", generator=gen)
    return u, v, mask, (count % m).int(), active, g, s, hg


def qn_case(tag, m, bsz, dim, dtype, schedule, gen, inputs=None,
            straddle: bool = True) -> float:
    """``broyden_step`` and ``qn_apply_multi`` (K = 1, 2 mixed, 4) on one
    case against their plain versions: the evicted rows and every unwritten
    ring row bit for bit, the rest at the row tolerance; two calls on clones
    of the same inputs bit for bit.  The plan must be ``schedule`` (None:
    whichever the planner picks), and a streaming case's slices must
    straddle a sample boundary (unless ``straddle`` is False: a path's own
    shape).  ``inputs`` replaces the drawn ``qn_case_inputs``."""
    u, v, mask, slot, active, g, s, hg = inputs or qn_case_inputs(
        m, bsz, dim, dtype, gen)
    vec = dim % (16 // u.element_size()) == 0
    for op, k in (("broyden", 1), ("qn", 1), ("qn", 4)):
        p = cuda_qn._plan_call(op, u, bsz, dim, k, vec)
        if schedule is not None and p.schedule != schedule:
            raise AssertionError(f"qn case {tag}: {op} planned {p}")
        if straddle and p.coop and not _straddles(p, bsz, dim):
            raise AssertionError(f"qn case {tag}: no slice straddles")
    alpha = torch.tensor(0.8, device="cuda")
    eps = 1e-8
    name = f"qn_case[{tag},{str(dtype)[6:]}]"
    want = ref.broyden_step_ref(u, v, g, s, hg, alpha, mask, slot, active,
                                eps)
    got = cuda_qn.broyden_step(u.clone(), v.clone(), g, s, hg, alpha, mask,
                               slot, active, eps)
    err = check_broyden_step(f"{name}.broyden_step", got, want, u, v, slot,
                             active, eps)
    again = cuda_qn.broyden_step(u.clone(), v.clone(), g, s, hg, alpha, mask,
                                 slot, active, eps)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}.broyden_step: two calls differ")
    rhs = torch.stack([g, s, hg, 0.5 * g])
    for flags in QN_FLAGS:
        xs = rhs[:len(flags)]
        want_q = ref.qn_apply_multi_ref(u, v, xs, alpha, mask, flags)
        got_q = cuda_qn.qn_apply_multi(u, v, xs, alpha, mask, flags)
        err = max(err, check_close(f"{name}.qn_apply_multi{flags}", got_q,
                                   want_q, row_tol(want_q, 1e-3, 1e-4)))
        if not torch.equal(got_q, cuda_qn.qn_apply_multi(u, v, xs, alpha,
                                                         mask, flags)):
            raise AssertionError(f"{name}.qn_apply_multi{flags}: two calls "
                                 "differ")
    return err


def kernel_qn_cases(gen) -> dict:
    """Every ``QN_CASES`` case in bf16 and f32: the largest error of each."""
    out = {}
    for tag, m, bsz, dim, schedule in QN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            err = qn_case(tag, m, bsz, dim, dtype, schedule, gen)
            out[f"{tag},{str(dtype)[6:]}"] = err
    tag, m, bsz, dim = PREFILL_WARM
    out[f"{tag},bfloat16"] = qn_case(tag, m, bsz, dim, torch.bfloat16, None,
                                     gen, qn_prefill_warm_inputs(gen))
    say("kernel_cases", name="broyden_step, qn_apply_multi",
        cases={**{t: f"m={m} B={b} D={d} {s}" for t, m, b, d, s in QN_CASES},
               tag: f"m={m} B={bsz} D=256x2304 bf16, counts "
               f"{list(PREFILL_WARM_COUNTS)}, rows "
               f"{list(PREFILL_WARM_SUFFIX)} zero past position "
               f"{PREFILL_WARM_PREFIX}"},
        flags=[list(f) for f in QN_FLAGS], max_abs_err=out,
        checked="evicted, refused and unwritten ring rows bit for bit; "
        "two calls on clones bit for bit; the rest at rtol 1e-3, atol 1e-4 "
        "x row max (slot rows 2e-2, 2e-3 x row max)")
    return out


# L2 flush between timed qN calls: the path runs four block evaluations
# between Broyden steps, which leave nothing of the ring in the 50 MB L2
FLUSH_BYTES = 256 << 20
FLUSH_KERNEL = "FillFunctor"


def _cold(fn):
    """``fn`` behind a write of FLUSH_BYTES (a fill kernel, left out of the
    device times by name)."""
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def run():
        buf.fill_(1)
        return fn()
    return run


def cold_device_ms(fn) -> float:
    """Device time per call of ``fn``'s kernels, each call after an L2
    flush (the flush left out)."""
    return sum(device_profile(_cold(fn), exclude=FLUSH_KERNEL).values())


def time_cold_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """CUDA-event time of ``fn`` alone per call, each call after an L2
    flush (the events bracket ``fn``, not the flush)."""
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in pairs:
        buf.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def qn_timing(name, fn, plain, nbytes, flops, shape, **extra) -> dict:
    """Cold-L2 event and per-kernel device times of one qN op (and its
    plain version's event time), its bound, and one ``kernel`` line."""
    ms = time_cold_ms(fn)
    by_kernel, calls = device_profile(_cold(fn), exclude=FLUSH_KERNEL,
                                      with_calls=True)
    plain_ms = time_cold_ms(plain, iters=5)
    b_ms, b_by = bound(nbytes, flops, "f32")
    # back to back, as earlier rows of PERF.md were timed: beside, not
    # instead of, the cold-L2 time
    warm = sum(device_profile(fn).values())
    row = dict(ms=ms, device_ms=sum(by_kernel.values()), plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
               launches_per_call=sum(calls.values()),
               device_ms_by_kernel=by_kernel, device_ms_warm=warm, **extra)
    say("kernel", name=name, l2="cold", **row)
    return row


def _qn_composition(u, v, x, beta, mask_t):
    """``H x`` as the shortest composition of PyTorch calls (a yardstick
    for ``qn_apply_multi``: not one call, and never called by the port):
    the rhs to the ring dtype, ``bmm`` for the coefficients ``V x``, the
    mask multiply, ``baddbmm`` for ``alpha x + U^T c``."""
    xb = x.to(u.dtype)[:, :, None]
    c = torch.bmm(v.transpose(0, 1), xb) * mask_t
    return torch.baddbmm(xb, u.transpose(0, 1).transpose(1, 2), c, beta=beta)


def qn_path_inputs(seq: int, gen, width: int = 2304, bsz: int = 4) -> dict:
    """The qN ops' inputs at the paths' ring: m=8, ``bsz`` <= 4 rows,
    D=seq*width, bf16 (``broyden_step``'s, and ``lowrank_append``'s hy, b,
    inv_den, upd)."""
    m, dim = 8, seq * width
    u, v, count, mask = _ring(m, bsz, dim, gen)

    def draw(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    return dict(seq=seq, m=m, bsz=bsz, dim=dim, u=u, v=v, mask=mask,
                g=draw(bsz, dim), s=0.1 * draw(bsz, dim), hg=draw(bsz, dim),
                alpha=torch.tensor(1.0, device="cuda"),
                slot=(count % m).int(),
                active=torch.tensor([True, True, False, True][:bsz],
                                    device="cuda"),
                eps=1e-8, hy=draw(bsz, dim), bvec=draw(bsz, dim),
                inv_den=draw(bsz),
                upd=torch.tensor([1.0, 1.0, 0.0, 1.0][:bsz], device="cuda"))


def time_qn_ops(inp: dict) -> dict:
    """The qN ops on ``qn_path_inputs``, each timed with a cold L2.  Needs
    only the wrappers' public signatures."""
    m, bsz, dim, seq = inp["m"], inp["bsz"], inp["dim"], inp["seq"]
    u, v, mask, g, s, hg = (inp[k] for k in ("u", "v", "mask", "g", "s",
                                              "hg"))
    alpha, slot, active, eps = (inp[k] for k in ("alpha", "slot", "active",
                                                 "eps"))
    d = dim // seq
    shape = f"m={m} B={bsz} D={seq}x{d}"
    ring = 2 * m * bsz * dim * 2
    rows = {}
    n_upd = int((active & (ref.broyden_step_ref(
        u, v, g, s, hg, alpha, mask, slot, active, eps)[4].abs() > eps)
        ).sum())  # slot rows written
    uu, vv = u.clone(), v.clone()
    rows["broyden_step"] = qn_timing(
        "broyden_step",
        lambda: cuda_qn.broyden_step(uu, vv, g, s, hg, alpha, mask, slot,
                                     active, eps),
        lambda: ref.broyden_step_ref(u, v, g, s, hg, alpha, mask, slot,
                                     active, eps),
        ring + 3 * bsz * dim * 4 + 2 * bsz * dim * 4 + 2 * bsz * dim * 2
        + n_upd * 2 * dim * 2, 8 * m * bsz * dim, shape)
    xs = g[None]
    q_bytes, q_flops = ring + 2 * bsz * dim * 4, 4 * m * bsz * dim
    mask_t = mask.t()[:, :, None].to(u.dtype)
    comp = lambda: _qn_composition(u, v, g, 1.0, mask_t)  # noqa: E731
    comp_dev = cold_device_ms(comp)
    rows["qn_apply_multi"] = qn_timing(
        "qn_apply_multi",
        lambda: cuda_qn.qn_apply_multi(u, v, xs, alpha, mask, (False,)),
        lambda: ref.qn_apply_multi_ref(u, v, xs, alpha, mask, (False,)),
        q_bytes, q_flops, f"m={m} B={bsz} K=1 D={seq}x{d}",
        composition_device_ms=comp_dev,
        composition="yardstick, not one call, never called by the port: "
        "x to bf16, bmm (V x), mask multiply, baddbmm (alpha x + U^T c), "
        "device time summed over its kernels")
    rows["qn_apply"] = qn_timing(
        "qn_apply", lambda: cuda_qn.qn_apply(u, v, g, alpha, mask),
        lambda: ref.qn_apply_ref(u, v, g, alpha, mask), q_bytes, q_flops,
        shape)
    # what a streaming read of one ring half reaches on this card, cold:
    # read as one linear stream (torch.sum), and as its m rows in lockstep
    # at the same offsets (torch.sum over the ring axis, which also writes
    # a (B, D) result), the pattern of the qN kernels' tiles
    reads = {"linear": lambda: u.sum(dtype=torch.float32),
             "rows_in_lockstep": lambda: u.sum(0)}
    ring_read = {k: cold_device_ms(f) for k, f in reads.items()}
    say("ring_read", shape=f"u: {shape} bf16", bytes=ring // 2,
        device_ms=ring_read, tb_per_s={k: ring / 2 / t / 1e9
                                       for k, t in ring_read.items()})
    rows["qn_apply_multi"]["ring_read_device_ms"] = ring_read
    hy, bvec, inv_den, upd = (inp[k] for k in ("hy", "bvec", "inv_den",
                                               "upd"))
    n_w = int((upd > 0.5).sum())
    uu, vv = u.clone(), v.clone()
    # slot rows read (u, v), evicted rows written; s/hy/b read and the slot
    # rows written only where upd (a refused row keeps its old contents);
    # (s - hy) * inv_den is 2 f32 operations per written entry
    rows["lowrank_append"] = qn_timing(
        "lowrank_append",
        lambda: cuda_qn.lowrank_append(uu, vv, s, hy, bvec, inv_den, slot,
                                       upd),
        lambda: ref.lowrank_append_ref(u, v, s, hy, bvec, inv_den, slot, upd),
        2 * bsz * dim * 2 + 2 * bsz * dim * 2
        + n_w * (3 * dim * 4 + 2 * dim * 2), 2 * n_w * dim, shape)
    return rows


def kernel_qn(seq: int, gen) -> dict:
    """The qN kernels against their plain versions at the paths' ring
    (``qn_path_inputs``), then their cold-L2 times."""
    inp = qn_path_inputs(seq, gen)
    errs = check_qn_path(inp)
    rows = time_qn_ops(inp)
    for name, r in rows.items():
        r["max_abs_err"] = errs[name]
    return rows


# the xLSTM DEQ drain's rings (d 2048, XLSTM_DEQ_PLENS over 4 slots):
# (S, B) of decode over the 4 slots, and of the prefill waves of two
# prompts of 64 and of 128
XLSTM_QN = (2048, ((1, 4), (64, 2), (128, 2)))
# the HuBERT-XLarge DEQ train step's ring (d 1280, AUDIO_DEQ_TRAIN's 4 x
# 1000 frames): broyden_step, the initial H g and the SHINE backward H^T w
AUDIO_QN = (1280, ((1000, 4),))


def kernel_qn_rings(gen, spec=XLSTM_QN) -> dict:
    """The qN kernels against their plain versions at the rings of
    ``spec`` (``XLSTM_QN``, ``AUDIO_QN``: the width and the (S, B) of
    each ring), at ``kernel_qn``'s tolerances: each kernel's largest
    error."""
    width, shapes = spec
    errs = {}
    for seq, bsz in shapes:
        for name, e in check_qn_path(qn_path_inputs(seq, gen, width,
                                                    bsz)).items():
            errs[name] = max(errs.get(name, 0.0), e)
    return errs


def check_qn_path(inp: dict) -> dict:
    """The four qN wrappers on ``qn_path_inputs`` against their plain
    versions: each one's largest error."""
    m, bsz, dim, seq = inp["m"], inp["bsz"], inp["dim"], inp["seq"]
    d = dim // seq
    u, v, mask, g, s, hg = (inp[k] for k in ("u", "v", "mask", "g", "s",
                                              "hg"))
    alpha, slot, active, eps = (inp[k] for k in ("alpha", "slot", "active",
                                                 "eps"))
    want = ref.broyden_step_ref(u, v, g, s, hg, alpha, mask, slot, active,
                                eps)
    got = cuda_qn.broyden_step(u.clone(), v.clone(), g, s, hg, alpha, mask,
                               slot, active, eps)
    tag = f"S={seq},d={d},B={bsz}"
    err_b = check_broyden_step(f"broyden_step[{tag}]", got, want, u, v,
                               slot, active, eps)
    xs = g[None]
    row = lambda w: row_tol(w, 1e-3, 1e-4)  # noqa: E731
    want_q = ref.qn_apply_multi_ref(u, v, xs, alpha, mask, (False,))
    got_q = cuda_qn.qn_apply_multi(u, v, xs, alpha, mask, (False,))
    err_q = check_close(f"qn_apply_multi[{tag}]", got_q, want_q,
                        row(want_q))
    for flags, rhs in (((False, True), torch.stack([g, s])),
                       ((True,), xs)):  # (True,): the SHINE backward H^T w
        want_m = ref.qn_apply_multi_ref(u, v, rhs, alpha, mask, flags)
        got_m = cuda_qn.qn_apply_multi(u, v, rhs, alpha, mask, flags)
        err_q = max(err_q, check_close(
            f"qn_apply_multi[{tag},{flags}]", got_m, want_m, row(want_m)))
    want_a = ref.qn_apply_ref(u, v, g, alpha, mask)
    got_a = cuda_qn.qn_apply(u, v, g, alpha, mask)
    err_a = check_close(f"qn_apply[{tag}]", got_a, want_a, row(want_a))
    hy, bvec, inv_den, upd = (inp[k] for k in ("hy", "bvec", "inv_den",
                                               "upd"))
    want_l = ref.lowrank_append_ref(u, v, s, hy, bvec, inv_den, slot, upd)
    got_l = cuda_qn.lowrank_append(u.clone(), v.clone(), s, hy, bvec,
                                   inv_den, slot, upd)
    err_l = check_lowrank_append(f"lowrank_append[{tag}]", got_l, want_l,
                                 u, v, slot, upd)
    errs = {"broyden_step": err_b, "qn_apply_multi": err_q,
            "qn_apply": err_a, "lowrank_append": err_l}
    say("kernel_check", shape=f"m={m} B={bsz} D={seq}x{d} bf16",
        max_abs_err=errs,
        checked="qn_apply_multi (False,), (False, True), (True,)",
        tol={"broyden_step ring": "evicted and unwritten rows equal; slot "
             "rows rtol 2e-2, atol 2e-3 x row max", "outputs":
             "rtol 1e-3, atol 1e-4 x row max", "den": TOL_F32})
    return errs


def kernel_qn_adjoint(gen) -> dict:
    """``qn_apply_multi`` at the adjoint-Broyden path's shape: both chains
    f32 whatever ``qn_dtype`` says, m=8, B=4, D=256x2304, applied as the
    mixed pair ``(False, True)`` (``H sigma`` with ``w^T H``) and, for the
    SHINE backward and ``B^T sigma``, as ``(True,)``.  Each against
    ``qn_apply_multi_ref`` at the row tolerance, then timed with a cold L2
    (and warm), beside its bound.  Returns one timing row per case."""
    m, bsz, seq = 8, 4, 256
    dim = seq * 2304
    u, v, _, mask = _ring(m, bsz, dim, gen, torch.float32)
    g = torch.randn(bsz, dim, device="cuda", generator=gen)
    s = torch.randn(bsz, dim, device="cuda", generator=gen)
    alpha = torch.tensor(1.0, device="cuda")
    ring = 2 * m * bsz * dim * 4
    rows = {}
    for tag, flags, xs in (("k2_mixed", (False, True), torch.stack([g, s])),
                           ("k1_transposed", (True,), g[None])):
        want = ref.qn_apply_multi_ref(u, v, xs, alpha, mask, flags)
        got = cuda_qn.qn_apply_multi(u, v, xs, alpha, mask, flags)
        err = check_close(f"qn_apply_multi[adjoint,{flags}]", got, want,
                          row_tol(want, 1e-3, 1e-4))
        kk = len(flags)
        rows[tag] = qn_timing(
            f"qn_apply_multi[adjoint {tag}]",
            lambda xs=xs, flags=flags: cuda_qn.qn_apply_multi(
                u, v, xs, alpha, mask, flags),
            lambda xs=xs, flags=flags: ref.qn_apply_multi_ref(
                u, v, xs, alpha, mask, flags),
            ring + 2 * kk * bsz * dim * 4, 4 * kk * m * bsz * dim,
            f"m={m} B={bsz} K={kk} {flags} D={seq}x2304 f32 ring",
            max_abs_err=err)
    say("kernel_check", shape=f"m={m} B={bsz} D={seq}x2304 f32 ring "
        "(adjoint Broyden's B and H chains)",
        max_abs_err={k: r["max_abs_err"] for k, r in rows.items()},
        tol="rtol 1e-3, atol 1e-4 x row max")
    return rows


def _sdpa(q, k, v, *, causal, mask=None):
    gqa = q.shape[2] != k.shape[2]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal, enable_gqa=gqa).transpose(1, 2)


def _attn_inputs(gen, bsz, seq, t, h, kvh, hd, dtype):
    q = torch.randn(bsz, seq, h, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(bsz, t, kvh, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(bsz, t, kvh, hd, device="cuda", generator=gen).to(dtype)
    return q, k, v


def _decode_inputs(gen, bsz, h, kvh, hd, t, dtype):
    q = torch.randn(bsz, h, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(bsz, t, kvh, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(bsz, t, kvh, hd, device="cuda", generator=gen).to(dtype)
    return q, k, v


def _lens(vals):
    return torch.tensor(vals, dtype=torch.int32, device="cuda")


# prefill cases besides "main" (the reported shape): (tag, B, S, T, H, KV,
# hd, dtype, kv_length, causal) -- GQA groups 1, 3, 4 and 6 (InternLM2's
# 48/8), ragged S and T (causal only with S >= T: the wrapper refuses
# causal T > S), a kv_length 0 row and lengths inside a tile, head
# dims 16, 64, 80, 96, 128 and 192 in bf16 and f32 (192 also at
# DeepSeek-V2-Lite's prefill shape, B=4 S=T=256 16/16 heads; 80 also at
# Zamba2's shared block, 32/32 heads, B=4 over its ragged 300-token prompt
# wave and its 512-token training sequences, and at HuBERT-XLarge's
# non-causal encoder, 16/16 heads over B=4 x 1000 frames; 128 also at
# Pixtral-12B's image prompt, 32/8 heads, B=2 x (1024 image + 128 text))
PREFILL_CASES = [
    ("gqa3", 4, 256, 256, 36, 12, 64, torch.bfloat16, None, True),
    ("gqa4", 2, 256, 256, 36, 9, 64, torch.bfloat16, None, True),
    ("ragged", 3, 197, 197, 36, 36, 64, torch.bfloat16, None, True),
    ("ragged_s_ne_t", 2, 230, 197, 36, 12, 64, torch.bfloat16, None, True),
    ("kv_length", 4, 256, 256, 36, 36, 64, torch.bfloat16,
     [256, 0, 37, 200], True),
    ("not_causal", 2, 130, 197, 36, 9, 64, torch.bfloat16, [150, 0], False),
    ("hd16", 3, 197, 197, 8, 2, 16, torch.bfloat16, [197, 0, 70], True),
    ("hd16_f32", 3, 197, 197, 8, 2, 16, torch.float32, [197, 0, 70], True),
    ("hd64_f32", 2, 197, 197, 8, 8, 64, torch.float32, [100, 0], True),
    ("hd80", 2, 230, 197, 32, 32, 80, torch.bfloat16, [197, 0], True),
    ("hd80_f32", 2, 197, 130, 8, 4, 80, torch.float32, [130, 0], True),
    ("hd96", 3, 197, 197, 32, 32, 96, torch.bfloat16, [197, 0, 37], True),
    ("hd96_f32", 2, 130, 130, 8, 8, 96, torch.float32, [100, 0], True),
    ("hd128_gqa", 2, 230, 197, 48, 8, 128, torch.bfloat16, [197, 0], True),
    ("hd128_f32", 2, 197, 130, 48, 8, 128, torch.float32, [130, 0], True),
    ("hd192", 2, 230, 197, 16, 16, 192, torch.bfloat16, [197, 0], True),
    ("hd192_f32", 4, 256, 256, 16, 16, 192, torch.float32, None, True),
    ("zamba2_s300", 4, 300, 300, 32, 32, 80, torch.bfloat16, None, True),
    ("zamba2_s300_f32", 4, 300, 300, 32, 32, 80, torch.float32, None, True),
    ("zamba2_s512", 4, 512, 512, 32, 32, 80, torch.bfloat16, None, True),
    ("zamba2_s512_f32", 4, 512, 512, 32, 32, 80, torch.float32, None, True),
    ("hubert_noncausal", 4, 1000, 1000, 16, 16, 80, torch.bfloat16, None,
     False),
    ("hubert_noncausal_f32", 4, 1000, 1000, 16, 16, 80, torch.float32, None,
     False),
    ("pixtral_img", 2, 1152, 1152, 32, 8, 128, torch.bfloat16, None, True),
    # examples/torch_train_deq_lm.py at its ~100M width (16 x 64 heads,
    # 8 x 256) and torch_serve_lm.py's smoke prefill waves (4 x 16 heads
    # over prompts of 4-15 tokens)
    ("deq_lm_100m", 8, 256, 256, 16, 16, 64, torch.bfloat16, None, True),
    ("serve_lm_smoke", 4, 15, 15, 4, 4, 16, torch.bfloat16, [15, 4, 9, 12],
     True),
]
# decode cases besides "main": (tag, B, H, KV, hd, T, dtype, kv_length) --
# kv_length at the split chunk's edges (CH-1, CH, CH+1, T) and 0, a cache
# shorter than one chunk, GQA (H=36, KV=12; 48/8), head dims 16, 64, 80,
# 96, 128 and 192 (bf16 and f32; 192 over V2-Lite's 512-token serving
# cache, 80 also over Zamba2's, 32/32 heads, 128 over Pixtral-12B's
# 2048-token cache, 32/8 heads); the "chunk_edges" cases also take the
# kv_length +-1 guard
_CH = cuda_fa.DECODE_CHUNK
DECODE_CASES = [
    ("chunk_edges", 4, 36, 36, 64, 1024, torch.bfloat16,
     [_CH - 1, _CH, _CH + 1, 1024]),
    ("short", 3, 36, 36, 64, 100, torch.bfloat16, [100, 0, 37]),
    ("gqa", 4, 36, 12, 64, 1024, torch.bfloat16, [129, 257, 0, 1024]),
    ("hd16", 3, 8, 2, 16, 300, torch.bfloat16, [300, 0, _CH + 1]),
    ("hd16_f32", 3, 8, 2, 16, 300, torch.float32, [300, 0, _CH + 1]),
    ("hd64_f32", 2, 8, 8, 64, 300, torch.float32, [_CH, 0]),
    ("hd80_chunk_edges", 4, 32, 32, 80, 1024, torch.bfloat16,
     [_CH - 1, _CH, _CH + 1, 1024]),
    ("hd80_f32", 3, 8, 8, 80, 300, torch.float32, [300, 0, _CH + 1]),
    ("hd96_chunk_edges", 4, 32, 32, 96, 1024, torch.bfloat16,
     [_CH - 1, _CH, _CH + 1, 1024]),
    ("hd96_f32", 3, 8, 8, 96, 300, torch.float32, [300, 0, _CH + 1]),
    ("hd128_chunk_edges", 4, 48, 8, 128, 1024, torch.bfloat16,
     [_CH - 1, _CH, _CH + 1, 0]),
    ("hd128_f32", 3, 48, 8, 128, 300, torch.float32, [300, 0, _CH + 1]),
    ("hd192_chunk_edges", 4, 16, 16, 192, 512, torch.bfloat16,
     [_CH - 1, _CH, _CH + 1, 512]),
    ("hd192_f32_chunk_edges", 4, 16, 16, 192, 512, torch.float32,
     [_CH - 1, _CH, _CH + 1, 512]),
    ("zamba2_chunk_edges", 4, 32, 32, 80, 512, torch.bfloat16,
     [_CH - 1, _CH, _CH + 1, 512]),
    ("zamba2_f32_chunk_edges", 4, 32, 32, 80, 512, torch.float32,
     [_CH - 1, _CH, _CH + 1, 512]),
    ("pixtral_chunk_edges", 4, 32, 8, 128, 2048, torch.bfloat16,
     [_CH - 1, _CH, _CH + 1, 2048]),
    # examples/torch_serve_lm.py: 4 slots over its 96-token caches
    ("serve_lm_smoke", 4, 4, 4, 16, 96, torch.bfloat16, [20, 5, 96, 40]),
]


def _tol(dtype, decode: bool) -> dict:
    if dtype == torch.float32:
        return TOL_F32
    return TOL_DECODE if decode else TOL_BF16


def _off_by_one_guard(name, fn, want, lens, t, tol) -> dict:
    """The tolerance must see ``kv_length`` off by one (on the rows whose
    length is not 0): the plain version at ``lens +- 1`` has to fail it."""
    out = {}
    live = (lens > 0).int()
    for shift in (1, -1):
        off = fn(torch.clamp(lens + shift * live, max=t))
        out[f"{shift:+d}"] = excess(off, want, tol)
        if out[f"{shift:+d}"] <= 0:
            raise AssertionError(f"{name}: kv_length {shift:+d} passes {tol}")
    return out


def kernel_attention(gen) -> dict:
    bf = torch.bfloat16
    # the reported prefill shape: the serve and train paths' B=4, S=T=256
    bsz, seq, h, hd = 4, 256, 36, 64
    q, k, v = _attn_inputs(gen, bsz, seq, seq, h, h, hd, bf)
    want = ref.attention_ref(q, k, v, causal=True)
    got = cuda_fa.flash_attention(q, k, v, causal=True)
    err = check_attention("flash_attention[main]", got, want, q, k, v, None,
                          TOL_BF16)
    ms = time_ms(lambda: cuda_fa.flash_attention(q, k, v, causal=True))
    dev = device_ms(lambda: cuda_fa.flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: ref.attention_ref(q, k, v, causal=True))
    lib = time_ms(lambda: _sdpa(q, k, v, causal=True))
    lib_dev = device_ms(lambda: _sdpa(q, k, v, causal=True))
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    flops = 4 * bsz * h * hd * seq * (seq + 1) / 2
    b_ms, b_by = bound(nbytes, flops, "bf16")
    shape = f"B={bsz} S=T={seq} H=KV={h} hd={hd} causal bf16"
    say("kernel", name="flash_attention", case="main", shape=shape,
        max_abs_err=err, tol=TOL_BF16, ms=ms, device_ms=dev, plain_ms=plain,
        library_ms=lib, library_device_ms=lib_dev, bound_ms=b_ms,
        bound_by=b_by)
    out = {"flash_attention": dict(
        max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
        library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
        shape=shape)}
    for tag, b_, s_, t_, h_, kv_, hd_, dt, lens, causal in PREFILL_CASES:
        q, k, v = _attn_inputs(gen, b_, s_, t_, h_, kv_, hd_, dt)
        kl = None if lens is None else _lens(lens)
        tol = _tol(dt, decode=False)
        want = ref.attention_ref(q, k, v, causal=causal, kv_length=kl)
        got = cuda_fa.flash_attention(q, k, v, kl, causal=causal)
        name = f"flash_attention[{tag}]"
        err = check_attention(name, got, want, q, k, v, kl, tol)
        guard = None
        if tag == "kv_length":
            guard = _off_by_one_guard(name, lambda x: ref.attention_ref(
                q, k, v, causal=causal, kv_length=x), want, kl, t_, tol)
        say("kernel_case", name="flash_attention", case=tag,
            shape=f"B={b_} S={s_} T={t_} H={h_} KV={kv_} hd={hd_} "
            f"{'causal ' if causal else ''}{str(dt)[6:]}", kv_length=lens,
            max_abs_err=err, tol=tol, kv_length_off_by_one_excess=guard)
        if dt == bf:
            out["flash_attention"]["max_abs_err"] = max(
                out["flash_attention"]["max_abs_err"], err)

    # the reported decode shape: 4 slots over a 1024-token cache
    bsz, h, hd, t = 4, 36, 64, 1024
    lens = _lens([129, 257, 200, 1024])
    q, k, v = _decode_inputs(gen, bsz, h, h, hd, t, bf)
    want = ref.decode_attention_ref(q, k, v, lens)
    got = cuda_fa.decode_attention(q, k, v, lens)
    err = check_attention("decode_attention[main]", got, want, q, k, v, lens,
                          TOL_DECODE)
    off_by_one = _off_by_one_guard(
        "decode_attention", lambda x: ref.decode_attention_ref(q, k, v, x),
        want, lens, t, TOL_DECODE)
    ms = time_ms(lambda: cuda_fa.decode_attention(q, k, v, lens))
    by_kernel = device_profile(lambda: cuda_fa.decode_attention(q, k, v,
                                                                lens))
    dev = sum(by_kernel.values())
    plain = time_ms(lambda: ref.decode_attention_ref(q, k, v, lens))
    amask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]
             )[:, None, None, :]
    lib = time_ms(lambda: _sdpa(q[:, None], k, v, causal=False, mask=amask))
    lib_dev = device_ms(lambda: _sdpa(q[:, None], k, v, causal=False,
                                      mask=amask))
    live = int(lens.sum())
    nbytes = 2 * q.numel() * 2 + 2 * live * h * hd * 2 + bsz * 4
    b_ms, b_by = bound(nbytes, 4 * h * hd * live, "bf16")
    shape = f"B={bsz} H=KV={h} hd={hd} T={t} kv_length={lens.tolist()} bf16"
    say("kernel", name="decode_attention", case="main", shape=shape,
        max_abs_err=err, tol=TOL_DECODE,
        kv_length_off_by_one_excess=off_by_one, ms=ms, device_ms=dev,
        plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
        bound_ms=b_ms, bound_by=b_by, launches_per_call=2,
        device_ms_by_kernel=by_kernel)
    out["decode_attention"] = dict(
        max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
        library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by, shape=shape,
        launches_per_call=2)
    for tag, b_, h_, kv_, hd_, t_, dt, lens in DECODE_CASES:
        q, k, v = _decode_inputs(gen, b_, h_, kv_, hd_, t_, dt)
        kl = _lens(lens)
        tol = _tol(dt, decode=True)
        want = ref.decode_attention_ref(q, k, v, kl)
        got = cuda_fa.decode_attention(q, k, v, kl)
        err = check_attention(f"decode_attention[{tag}]", got, want, q, k, v,
                              kl, tol)
        guard = None
        if tag.endswith("chunk_edges"):
            guard = _off_by_one_guard(
                f"decode_attention[{tag}]",
                lambda x: ref.decode_attention_ref(q, k, v, x), want, kl, t_,
                tol)
        say("kernel_case", name="decode_attention", case=tag,
            shape=f"B={b_} H={h_} KV={kv_} hd={hd_} T={t_} {str(dt)[6:]}",
            kv_length=lens, max_abs_err=err, tol=tol,
            kv_length_off_by_one_excess=guard)
        if dt == bf:
            out["decode_attention"]["max_abs_err"] = max(
                out["decode_attention"]["max_abs_err"], err)
    for name, rows in kernel_attention_head_dims(gen).items():
        out[name]["head_dims"] = rows
    return out


# the registry's other head dims, each at its config's heads (H, KV)
HEAD_DIM_CONFIGS = {80: ("stablelm-3b", 32, 32), 96: ("phi3-mini-3.8b", 32, 32),
                    128: ("internlm2-20b", 48, 8)}
# the attention kernels' head dims past 64, timed: key -> (config, H, KV,
# hd, prefill S = T, decode cache length T, prefill B, causal); each
# config's heads at B=4 S 256 and T 1024 (V2-Lite's MLA at qk 128 + 64, v
# padded, over its 512-token serving cache), Zamba2's shared block at hd
# 80 over its ragged 300-token prompt wave and its 512-token training
# sequences, decoding over its 512-token serving cache; HuBERT-XLarge's
# encoder at hd 80, not causal, over B=4 x 1000 frames; Pixtral-12B at
# hd 128 (32/8 heads) over B=2 x (1024 image + 128 text) tokens and
# decoding over its 2048-token serving cache
ATTN_HEAD_DIMS = {str(hd): (arch, h, kvh, hd, 256, 1024, 4, True)
                  for hd, (arch, h, kvh) in HEAD_DIM_CONFIGS.items()}
ATTN_HEAD_DIMS["192"] = ("deepseek-v2-lite-16b", 16, 16, 192, 256, 512, 4,
                         True)
ATTN_HEAD_DIMS["80_zamba2_s300"] = ("zamba2-2.7b", 32, 32, 80, 300, 512, 4,
                                    True)
ATTN_HEAD_DIMS["80_zamba2_s512"] = ("zamba2-2.7b", 32, 32, 80, 512, None, 4,
                                    True)
ATTN_HEAD_DIMS["80_hubert_noncausal"] = ("hubert-xlarge", 16, 16, 80, 1000,
                                         None, 4, False)
ATTN_HEAD_DIMS["128_pixtral"] = ("pixtral-12b", 32, 8, 128, 1152, 2048, 2,
                                 True)


def kernel_attention_head_dims(gen) -> dict:
    """Prefill (the entry's B, S=T, causal or not) and decode (B=4 over a
    T-token cache, lengths 129, 257, 200 and T) at each entry of
    ``ATTN_HEAD_DIMS`` with its config's heads, bf16: checked against the
    plain version and timed cold (event and device time after an L2
    flush) and warm (device time back to back) beside SDPA (masked for
    decode) and the bound (a causal product counts the cells on and under
    the diagonal)."""
    bf = torch.bfloat16
    out = {"flash_attention": {}, "decode_attention": {}}
    for key, (arch, h, kvh, hd, seq, t, pbsz, causal) in \
            ATTN_HEAD_DIMS.items():
        q, k, v = _attn_inputs(gen, pbsz, seq, seq, h, kvh, hd, bf)
        kern = lambda: cuda_fa.flash_attention(  # noqa: E731
            q, k, v, causal=causal)
        lib = lambda: _sdpa(q, k, v, causal=causal)  # noqa: E731
        err = check_attention(f"flash_attention[{arch}]", kern(),
                              ref.attention_ref(q, k, v, causal=causal),
                              q, k, v, None, TOL_BF16)
        cells = seq * (seq + 1) / 2 if causal else seq * seq
        b_ms, b_by = bound(2 * q.numel() * 2 + 2 * k.numel() * 2,
                           4 * pbsz * h * hd * cells, "bf16")
        row = out["flash_attention"][key] = dict(
            config=arch, shape=f"B={pbsz} S=T={seq} H={h} KV={kvh} hd={hd} "
            f"{'causal' if causal else 'not causal'} bf16", max_abs_err=err,
            ms=time_cold_ms(kern), device_ms=cold_device_ms(kern),
            device_ms_warm=device_ms(kern),
            plain_ms=time_ms(lambda: ref.attention_ref(q, k, v,
                                                       causal=causal)),
            library_ms=time_cold_ms(lib),
            library_device_ms=cold_device_ms(lib),
            library_device_ms_warm=device_ms(lib),
            bound_ms=b_ms, bound_by=b_by)
        say("kernel_case", name="flash_attention", case=f"hd{key}", **row)
        if t is None:
            continue
        bsz = 4
        lens = _lens([129, 257, 200, t])
        q, k, v = _decode_inputs(gen, bsz, h, kvh, hd, t, bf)
        kern = lambda: cuda_fa.decode_attention(q, k, v, lens)  # noqa: E731
        amask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]
                 )[:, None, None, :]
        lib = lambda: _sdpa(q[:, None], k, v, causal=False,  # noqa: E731
                            mask=amask)
        err = check_attention(f"decode_attention[{arch}]", kern(),
                              ref.decode_attention_ref(q, k, v, lens),
                              q, k, v, lens, TOL_DECODE)
        live = int(lens.sum())
        b_ms, b_by = bound(2 * q.numel() * 2 + 2 * live * kvh * hd * 2
                           + bsz * 4, 4 * h * hd * live, "bf16")
        row = out["decode_attention"][key] = dict(
            config=arch, shape=f"B={bsz} H={h} KV={kvh} hd={hd} T={t} "
            f"kv_length={lens.tolist()} bf16", max_abs_err=err,
            ms=time_cold_ms(kern), device_ms=cold_device_ms(kern),
            device_ms_warm=device_ms(kern),
            plain_ms=time_ms(lambda: ref.decode_attention_ref(q, k, v,
                                                              lens)),
            library_ms=time_cold_ms(lib),
            library_device_ms=cold_device_ms(lib),
            library_device_ms_warm=device_ms(lib),
            bound_ms=b_ms, bound_by=b_by, launches_per_call=2)
        say("kernel_case", name="decode_attention", case=f"hd{key}", **row)
    return out


# rmsnorm shapes (rows, D): the registry's widths at the paths' 1024 rows
# (B=4 x S=256) and at the decode shape (4 slots) -- DeepSeek's 2048 and
# MLA's kv_norm 512 among them; Zamba2's 2560 and its Mamba2 gated width
# 5120 also at 2048 rows (its 4 x 512 training batch); xLSTM-1.3B's 2048
# at its 4 x 300 prefill wave and its 4 x 512 training batch;
# HuBERT-XLarge's 1280 at its 4 x 1000 training batch (and 4 rows);
# Pixtral-12B's 5120 at its 2 x 1152 image prompt and its 2 x 1536 training
# batch -- a ragged row count and a width with no vector instance (the
# generic kernel); the first is the reported row
RMS_SHAPES = [(1024, 2304), (1024, 2560), (1024, 3072), (1024, 6144),
              (1024, 2048), (1024, 512), (4, 2304), (4, 6144), (4, 2048),
              (4, 512), (1000, 2304), (1024, 64), (4, 2560), (1024, 5120),
              (4, 5120), (2048, 2560), (2048, 5120), (1200, 2048),
              (2048, 2048), (4000, 1280), (4, 1280), (2304, 5120),
              (3072, 5120), (2048, 1024)]


def kernel_rmsnorm(gen) -> dict:
    """The rmsnorm kernel against its plain version at every shape of
    ``RMS_SHAPES`` in bf16 (``TOL_BF16``) and f32 (``TOL_F32``); in bf16
    each shape also timed in turns against ``F.rms_norm`` (the yardstick,
    never called by the port): kernel, library, library, kernel, each call
    after an L2 flush (``device_ms``, ``ms``: x comes from HBM, as the
    byte bound counts it), then the same turns back to back
    (``device_ms_warm``: x stays in the L2)."""
    eps = 1e-5
    shapes, err_all = {}, 0.0
    for dt in (torch.bfloat16, torch.float32):
        for rows, d in RMS_SHAPES:
            x = torch.randn(rows, d, device="cuda", generator=gen).to(dt)
            w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
                 ).to(dt)
            tag = f"{rows}x{d} {str(dt)[6:]}"
            err = check_close(f"rmsnorm[{tag}]", cuda_rms.rmsnorm(x, w, eps),
                              ref.rmsnorm_ref(x, w, eps),
                              TOL_BF16 if dt == torch.bfloat16 else TOL_F32)
            err_all = max(err_all, err)
            p = cuda_rms.plan(rows, d, dt)
            row = dict(max_abs_err=err, per=p.per, warps_per_row=p.wpr,
                       n_cta=p.n_cta, threads=p.threads)
            if dt == torch.bfloat16:
                kern = lambda: cuda_rms.rmsnorm(x, w, eps)  # noqa: E731
                lib = lambda: F.rms_norm(x, (d,), w, eps)  # noqa: E731
                cold = [cold_device_ms(f) for f in (kern, lib, lib, kern)]
                warm = [device_ms(f) for f in (kern, lib, lib, kern)]
                row.update(
                    device_ms=min(cold[0], cold[3]),
                    library_device_ms=min(cold[1], cold[2]),
                    device_ms_warm=min(warm[0], warm[3]),
                    library_device_ms_warm=min(warm[1], warm[2]),
                    turns_device_ms=cold, turns_device_ms_warm=warm,
                    ms=time_cold_ms(kern), library_ms=time_cold_ms(lib),
                    plain_ms=time_cold_ms(
                        lambda: ref.rmsnorm_ref(x, w, eps), iters=5))
                row["bound_ms"], row["bound_by"] = bound(
                    2 * rows * d * 2 + d * 2, 4 * rows * d, "f32")
            shapes[tag] = row
            say("kernel_case", name="rmsnorm", shape=tag, **row)
    main = shapes["1024x2304 bfloat16"]
    out = {k: main[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                "library_device_ms", "device_ms_warm",
                                "library_device_ms_warm", "bound_ms",
                                "bound_by")}
    out.update(max_abs_err=err_all, shape="rows=1024 D=2304 bf16",
               shapes=shapes)
    say("kernel", name="rmsnorm", **{k: v for k, v in out.items()
                                     if k != "shapes"})
    return {"rmsnorm": out}


def _wrapper_and_plain_grads(op, plain, inputs, cot):
    """``(out, grads)`` of the op's autograd wrapper and of plain autograd
    through its plain version, on the same inputs and cotangent."""
    res = []
    for fn in (op, plain):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        res.append((out.detach(), torch.autograd.grad(out, leaves, cot)))
    return res


# the attention shapes training takes gradients at: MiniCPM-2B's (B=4,
# S=256, 36 x 64), DeepSeek-V2-Lite's MLA (16 x 192, v padded) and
# Zamba2's shared block (B=4, S=512, 32 x 80)
GRAD_ATTN_SHAPES = [(4, 256, 36, 64), (4, 256, 16, 192), (4, 512, 32, 80)]


def kernel_grads(gen) -> None:
    """The gradients training takes through the attention and rmsnorm
    kernels, at the training shapes (``GRAD_ATTN_SHAPES``; rmsnorm over
    1024 x 2304), bf16."""
    for bsz, seq, h, hd in GRAD_ATTN_SHAPES:
        q, k, v, g = (torch.randn(bsz, seq, h, hd, device="cuda",
                                  generator=gen).to(torch.bfloat16)
                      for _ in range(4))
        (out_w, g_w), (out_p, g_p) = _wrapper_and_plain_grads(
            lambda *a: ops.attention(*a, causal=True),
            lambda *a: ref.attention_ref(*a, causal=True), (q, k, v), g)
        err_f = check_close(f"attention.forward hd{hd}", out_w, out_p,
                            TOL_BF16)
        err_a = check_grads(f"attention hd{hd}", g_w, g_p)
        say("kernel_grad", name="flash_attention", shape=f"B={bsz} "
            f"S=T={seq} H=KV={h} hd={hd} causal bf16", forward_err=err_f,
            max_abs_err=err_a, bitwise_equal=all(
                torch.equal(a, b) for a, b in zip(g_w, g_p)),
            tol="rtol 2e-2, atol 2e-3 x max")
    rows, d = 1024, 2304
    x = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
         ).to(torch.bfloat16)
    gx = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
    (out_w, g_w), (out_p, g_p) = _wrapper_and_plain_grads(
        lambda *a: ops.rmsnorm(*a, 1e-5),
        lambda *a: ref.rmsnorm_ref(*a, 1e-5), (x, w), gx)
    err_f = check_close("rmsnorm.forward", out_w, out_p, TOL_BF16)
    err_r = check_grads("rmsnorm", g_w, g_p)
    say("kernel_grad", name="rmsnorm", shape=f"rows={rows} D={d} bf16",
        forward_err=err_f, max_abs_err=err_r, bitwise_equal=all(
            torch.equal(a, b) for a, b in zip(g_w, g_p)),
        tol="rtol 2e-2, atol 2e-3 x max")


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    decode_qn = kernel_qn(1, gen)   # decode-shaped ring, checked and timed
    res.update(kernel_qn(256, gen))  # prefill-shaped ring: the reported row
    for name, row in decode_qn.items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                       row["max_abs_err"])
        for key in ("ms", "device_ms", "bound_ms", "launches_per_call"):
            res[name][f"decode_{key}"] = row[key]
    for tag, row in kernel_qn_adjoint(gen).items():
        q = res["qn_apply_multi"]
        q["max_abs_err"] = max(q["max_abs_err"], row["max_abs_err"])
        for key in ("ms", "device_ms", "device_ms_warm", "bound_ms",
                    "plain_ms", "launches_per_call", "shape"):
            q[f"adjoint_{tag}_{key}"] = row[key]
    for spec in (XLSTM_QN, AUDIO_QN):
        for name, err in kernel_qn_rings(gen, spec).items():
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    kernel_qn_cases(gen)
    for name, row in kernel_qn_mdeq(gen).items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                       row["max_abs_err"])
        for key in ("ms", "device_ms", "device_ms_warm", "bound_ms",
                    "bound_by", "plain_ms", "launches_per_call", "shape"):
            res[name][f"mdeq_{key}"] = row[key]
    res.update(kernel_attention(gen))
    res.update(kernel_rmsnorm(gen))
    kernel_grads(gen)
    torch.cuda.synchronize()
    return res


# the MDEQ path's ring (MDEQConfig(): memory 18; per sample a state of
# 32x32x24 + 16x16x48 = 36864 f32; batch 128; bf16 ring): m=18 takes the
# M=32 template, and the streaming schedule cuts B*D into slices that
# straddle samples
MDEQ_QN = ("mdeq", 18, 128, 36864)


def kernel_qn_mdeq(gen) -> dict:
    """Both qN kernels at ``MDEQ_QN``: the checks of ``qn_case`` (the
    streaming schedule, slices that straddle samples, the row kinds of
    ``QN_CASES``), then each timed with a cold L2 (and warm) on a full ring
    (18 live slots a row, every row active): ``broyden_step``, whose
    append then evicts slot 0 (the most an MDEQ iteration can move), and
    ``qn_apply_multi`` as the SHINE backward calls it, ``(True,)``.  The
    bounds count the 18 rows the ring holds, not the template's 32."""
    tag, m, bsz, dim = MDEQ_QN
    err = qn_case(tag, m, bsz, dim, torch.bfloat16, "streaming", gen)
    u, v, _, _ = _ring(m, bsz, dim, gen)
    mask = torch.ones(m, bsz, device="cuda")
    slot = torch.zeros(bsz, dtype=torch.int32, device="cuda")
    active = torch.ones(bsz, dtype=torch.bool, device="cuda")
    g, s, hg = (torch.randn(bsz, dim, device="cuda", generator=gen)
                for _ in range(3))
    s = 0.1 * s
    alpha = torch.tensor(1.0, device="cuda")
    vec32 = bsz * dim * 4
    ring = 2 * m * bsz * dim * 2
    shape = f"m={m} B={bsz} D={dim} f32 state, bf16 ring"
    uu, vv = u.clone(), v.clone()
    rows = {"broyden_step": qn_timing(
        "broyden_step[mdeq]",
        lambda: cuda_qn.broyden_step(uu, vv, g, s, hg, alpha, mask, slot,
                                     active, 1e-8),
        lambda: ref.broyden_step_ref(u, v, g, s, hg, alpha, mask, slot,
                                     active, 1e-8),
        # ring, g/s/hg read, hg_new/b written, evicted and slot rows
        ring + 3 * vec32 + 2 * vec32 + 2 * bsz * dim * 2
        + 2 * bsz * dim * 2, 8 * m * bsz * dim, shape, max_abs_err=err)}
    xs = g[None]
    rows["qn_apply_multi"] = qn_timing(
        "qn_apply_multi[mdeq]",
        lambda: cuda_qn.qn_apply_multi(u, v, xs, alpha, mask, (True,)),
        lambda: ref.qn_apply_multi_ref(u, v, xs, alpha, mask, (True,)),
        ring + 2 * vec32, 4 * m * bsz * dim, f"{shape}, K=1 (True,)",
        max_abs_err=err)
    return rows


# ---------------------------------------------------------------------------
# phase 3: end-to-end check at a small size (card vs CPU)
# ---------------------------------------------------------------------------


def _map(fn, params: dict) -> dict:
    """``fn`` over every tensor of a parameter tree."""
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def _scaled_blocks(params: dict, scale: float) -> dict:
    """Scale the weight-tied blocks, and the hybrid's shared block that
    every tied unit calls (a random init is not contractive at scale 1; the
    JAX package's tests use 0.3)."""
    return dict(params, **{k: _map(lambda t: t * scale, params[k])
                           for k in ("deq_blocks", "shared_attn")
                           if k in params})


def _at_head_dim(cfg, arch: str):
    """The smoke config at ``arch``'s real head dim with 2 query heads (2
    kv heads; 1 where ``arch`` groups its heads, as InternLM2 does)."""
    real = get_config(arch)
    return dataclasses.replace(
        cfg, head_dim=real.head_dim, num_heads=2,
        num_kv_heads=1 if real.num_kv_heads < real.num_heads else 2)


def phase_parity(solver: str = "broyden", arch: str | None = None) -> None:
    """The smoke config in f32 served by ``solver`` on the card and on the
    CPU: the same tokens and solver steps, logits within 1e-3 of their
    scale (a non-Broyden solver runs the frozen-row and carry paths with
    its own carry rules).  With ``arch``, at that config's head dim
    (``_at_head_dim``)."""
    cfg = smoke_config("minicpm-2b", deq=True)
    if arch is not None:
        cfg = _at_head_dim(smoke_config(arch, deq=True), arch)
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        deq=dataclasses.replace(cfg.deq, max_steps=30, tol=1e-4, memory=16,
                                qn_dtype="float32", solver=solver))
    cpu_params = _scaled_blocks(lm.init_params(cfg, seed=1, device="cpu"),
                                0.3)
    gpu_params = _map(lambda t: t.to("cuda"), cpu_params)
    rng = np.random.default_rng(0)
    lens = [5, 9, 5, 12, 9, 5]
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in lens]
    outs = {}
    for name, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        loop = ServeLoop(params, cfg, slots=2, max_len=32, record=True)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=5)
                for i, p in enumerate(prompts)]
        loop.drain(reqs)
        outs[name] = (reqs, loop)
    (rg, lg), (rc, lc) = outs["cuda"], outs["cpu"]
    toks_g = [r.out for r in rg]
    toks_c = [r.out for r in rc]
    if toks_g != toks_c:
        raise AssertionError(f"card and CPU tokens differ: {toks_g} vs "
                             f"{toks_c}")
    steps_g = [s["steps"] for s in lg.solve_log]
    steps_c = [s["steps"] for s in lc.solve_log]
    if arch is not None and steps_g != steps_c:
        raise AssertionError(f"{arch}: card and CPU solver steps differ: "
                             f"{steps_g} vs {steps_c}")
    err = max(float(np.abs(a - b).max())
              for uid in lc.recorded_logits
              for a, b in zip(lg.recorded_logits[uid],
                              lc.recorded_logits[uid]))
    scale = max(float(np.abs(b).max()) for v in lc.recorded_logits.values()
                for b in v)
    if err > 1e-3 * max(scale, 1.0):
        raise AssertionError(f"card vs CPU logits differ by {err:.3e} "
                             f"(scale {scale:.3e})")
    say("parity", config=f"{cfg.name} smoke f32 (d=64, 2 blocks x0.3, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim})",
        solver=solver, requests=len(prompts), tokens_identical=True,
        max_abs_logit_err=err, logit_scale=scale, steps_card=steps_g,
        steps_cpu=steps_c)


def phase_train_parity(solver: str = "broyden",
                       arch: str | None = None) -> None:
    """Three train steps of the smoke config in f32 (f32 ring) with forward
    solver ``solver`` and the ``shine_fallback`` backward on the card and
    on the CPU from the same weights and batches.  Held: the same forward
    solver steps, the loss at rtol 1e-4 and the grad norm at rtol 2e-3 (the
    SHINE gradient applies the inverse each device builds from its own
    quasi-Newton pairs, whose last pairs move with f32 rounding, as between
    the two packages in ``tests/test_torch_training.py``)."""
    cfg = smoke_config("minicpm-2b", deq=True)
    if arch is not None:
        cfg = _at_head_dim(smoke_config(arch, deq=True), arch)
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        deq=dataclasses.replace(cfg.deq, qn_dtype="float32", solver=solver,
                                backward="shine_fallback"))
    tcfg = TrainConfig(steps=3, global_batch=2, seq_len=16, lr=1e-3,
                       warmup_steps=2)
    cpu_params = _scaled_blocks(lm.init_params(cfg, seed=1, device="cpu"),
                                0.3)
    ds = SyntheticTokenDataset(cfg.vocab_size, 0)
    seen = {}
    for dev in ("cuda", "cpu"):
        state = train_steps.init_train_state(cfg, tcfg,
                                             params=_map(lambda t: t.to(dev),
                                                         cpu_params))
        step = train_steps.build_train_step(cfg, tcfg)
        seen[dev] = []
        for i in range(3):
            toks = torch.from_numpy(ds.batch(i, 2, 17)).to(dev)
            state, m = step(state, {"tokens": toks[:, :-1],
                                    "targets": toks[:, 1:]})
            seen[dev].append((m["deq_steps"], float(m["loss"]),
                              float(m["grad_norm"])))
    for i, ((sg, lg, gg), (sc, lc, gc)) in enumerate(zip(seen["cuda"],
                                                         seen["cpu"])):
        if sg != sc or abs(lg - lc) > 1e-4 * abs(lc) \
                or abs(gg - gc) > 2e-3 * abs(gc):
            raise AssertionError(f"train step {i} ({solver}): card "
                                 f"{seen['cuda'][i]} vs CPU "
                                 f"{seen['cpu'][i]}")
    say("train_parity", config=f"{cfg.name} smoke f32 (d=64, 2 blocks x0.3, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, ring "
        "f32), batch 2 x 16, 3 AdamW steps", solver=solver,
        backward="shine_fallback", card=seen["cuda"],
        cpu=seen["cpu"], tol="same solver steps; loss rtol 1e-4; grad norm "
        "rtol 2e-3")


# ---------------------------------------------------------------------------
# phase 4: serve at the full width of MiniCPM-2B
# ---------------------------------------------------------------------------


def phase_serve(smi: str) -> tuple[dict, int, dict, object]:
    cfg = get_config("minicpm-2b", deq=True)
    t0 = time.perf_counter()
    params = _scaled_blocks(lm.init_params(cfg, seed=0, device="cuda"), 0.3)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    plens = [128, 256] * 4
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in plens]
    loop = ServeLoop(params, cfg, slots=4, max_len=1024, record=False)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    loop.drain(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches.counts()
    summ = serve_summary(loop, reqs, secs)
    for r in reqs:
        full = len(r.out) == r.max_new_tokens or (
            r.out and r.out[-1] == loop.eos)
        if not full or r.error is not None:
            raise AssertionError(f"request {r.uid}: {len(r.out)} tokens, "
                                 f"error {r.error}")
    say("serve", config="minicpm-2b DEQ (d=2304, 36x64 heads, ff=5760, "
        "vocab 122753, 4 blocks x0.3, bf16, ring bf16 m=8)",
        init_seconds=round(t_init, 2),
        tokens_per_request=[len(r.out) for r in reqs],
        prompt_lens=plens, card=smi, **summ,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    steps = [(s["phase"], s["steps"]) for s in loop.solve_log]
    statuses = sorted({c for s in loop.solve_log for c in s["status"]})
    say("serve_solves", n_solves=len(steps),
        prefill_steps=[s for p, s in steps if p == "prefill"],
        decode_steps=[s for p, s in steps if p == "decode"],
        statuses_seen=statuses)
    say("serve_launches", **counts)
    missing = [k for k in SERVE_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serve path: "
                             f"{missing}")
    return counts, len(steps), params, cfg


def phase_serve_configs(smi: str) -> dict:
    """A drain at the full width of each config of ``HEAD_DIM_CONFIGS``
    (DEQ defaults, random weights from seed 0 with the blocks scaled by
    0.3, bf16): 2 requests of 128-token prompts over 2 slots, 4 new tokens,
    a 256-token cache, launch counts reset just before and read just after.
    Each request must be served in full with no fault and finite logits,
    and both attention kernels must have launched.  The peak memory is the
    drain's and its model's, over what the script held before."""
    out = {}
    for hd, (arch, _, _) in HEAD_DIM_CONFIGS.items():
        cfg = get_config(arch, deq=True)
        base = torch.cuda.memory_allocated()  # what the script holds besides
        params = _scaled_blocks(lm.init_params(cfg, seed=0, device="cuda"),
                                0.3)
        rng = np.random.default_rng(0)
        loop = ServeLoop(params, cfg, slots=2, max_len=256, record=True)
        reqs = [Request(uid=i, max_new_tokens=4, prompt=rng.integers(
            2, cfg.vocab_size, size=128).tolist()) for i in range(2)]
        ttft = obs_metrics.default_registry().histogram("serve_ttft_ms")
        ttft0 = (ttft.sum, ttft.count)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        t0 = time.perf_counter()
        loop.drain(reqs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches.counts()
        summ = serve_summary(loop, reqs, secs)
        # this drain's own first tokens (the histogram is the process's)
        summ["ttft_ms_mean"] = ((ttft.sum - ttft0[0])
                                / max(ttft.count - ttft0[1], 1))
        del summ["ttft_ms_max"]
        for r in reqs:
            if len(r.out) != r.max_new_tokens or r.error is not None:
                raise AssertionError(f"{arch} request {r.uid}: "
                                     f"{len(r.out)} tokens, error {r.error}")
            if not all(np.isfinite(x).all()
                       for x in loop.recorded_logits[r.uid]):
                raise AssertionError(f"{arch} request {r.uid}: non-finite "
                                     f"logits")
        missing = [k for k in ("flash_attention", "decode_attention",
                               "rmsnorm") if counts[k] == 0]
        if missing:
            raise AssertionError(f"{arch}: kernels not launched: {missing}")
        row = out[arch] = dict(
            head_dim=hd, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
            d_model=cfg.d_model, **summ,
            peak_mem_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            solve_steps=[(s["phase"], s["steps"]) for s in loop.solve_log],
            launches={k: n for k, n in counts.items() if n})
        say("serve_config", config=f"{arch} DEQ (d={cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {hd}, ff="
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, 4 blocks x0.3, bf16)",
            card=smi, **row)
        del params, loop
        torch.cuda.empty_cache()
    return out


# phase_serve_prefix: the arms, one after another on the same card and
# weights (DEQ 4 blocks x0.3, bf16, ring bf16 m=8), each a ServeLoop over 4
# slots and a 1024-token cache.  A prefix block of 128 publishes each
# prompt at 128 and its full length, so 16 entries (sync) or rows (async)
# hold the whole stream.  The solves stop at a relative residual of
# PREFIX_TOL: a full-width bf16 solve levels off at ~2.5e-3
# (``residual_floor``), under the DEQSettings default of 1e-3, where every
# solve, cold or seeded, runs to max_steps and no warm start can save an
# iteration; at 1e-2 a cold prefill stops after ~6.
PREFIX_TOL = 1e-2
PREFIX_KW = dict(prefix_cache=True, prefix_cache_slots=16, prefix_block=128)
PREFIX_ARMS = {
    "a_sync": dict(pipeline="sync"),
    "b_sync_prefix": dict(pipeline="sync", record=True, **PREFIX_KW),
    "c_async_prefix": dict(pipeline="async", async_depth=2, record=True,
                           **PREFIX_KW),
    "d_async_prefix_reorder": dict(pipeline="async", async_depth=2,
                                   reorder=True, **PREFIX_KW),
}
ASYNC_ARMS = ("c_async_prefix", "d_async_prefix_reorder")


def prefix_stream(vocab: int, seed: int = 0) -> list[list[int]]:
    """12 prompts: four random 128-token bases, sent alone, then again as
    exact repeats, then each with a random 128-token suffix."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(2, vocab, size=128).tolist() for _ in range(4)]
    return bases + [list(b) for b in bases] + [
        b + rng.integers(2, vocab, size=128).tolist() for b in bases]


@contextlib.contextmanager
def _record_prefill_solves(out: list):
    """Note every Broyden solve at a prefill shape (S > 1) made inside the
    block: its rows, length, steps, its ``broyden_step`` launches, and the
    ring count each row entered with (0 for a cold row), kept on the card
    and read after the block."""
    orig = implicit_solvers.broyden_solve

    def recorded(g, z0, cfg, *, carry=None, **kw):
        if z0.ndim < 3 or z0.shape[1] == 1:
            return orig(g, z0, cfg, carry=carry, **kw)
        counts = None if carry is None else torch.where(
            carry.warm, carry.lowrank.count,
            torch.zeros_like(carry.lowrank.count))
        n0 = launches.counts()["broyden_step"]
        res = orig(g, z0, cfg, carry=carry, **kw)
        out.append({"rows": z0.shape[0], "seq": z0.shape[1],
                    "steps": res.n_steps, "counts": counts,
                    "broyden_step": launches.counts()["broyden_step"] - n0})
        return res

    with mock.patch.object(implicit_solvers, "broyden_solve", recorded):
        yield


def residual_floor(params, cfg, prompts: list, steps: int = 30) -> list:
    """The mean relative residual (``||g(z)|| / max(||z0||, 1)``) after
    each of ``steps`` Broyden iterations of one cold prefill of
    ``prompts`` with no stop test: where the solve levels off."""
    traces = []
    orig = implicit_solvers.broyden_solve

    def recorded(g, z0, scfg, **kw):
        res = orig(g, z0, scfg, **kw)
        zn = z0.float().flatten(1).norm(dim=1).clamp(min=1.0)
        traces.append((res.trace / zn).mean(dim=1))
        return res

    fcfg = dataclasses.replace(cfg, deq=dataclasses.replace(
        cfg.deq, tol=0.0, max_steps=steps))
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    with mock.patch.object(implicit_solvers, "broyden_solve", recorded):
        lm.prefill(params, {"tokens": toks}, fcfg, 1024)
    return traces[0].tolist()


def async_expected_syncs(solve_log: list, max_steps: int) -> int:
    """The host waits an async drain makes: the solver's own reads for
    every solve of the drain (``expected_syncs`` with no loop read) and the
    one wait that pins the card's clock for the TTFT stamps."""
    return expected_syncs([s["steps"] for s in solve_log], max_steps, 0) + 1


def check_prefix_arms(arms: dict) -> None:
    """What ``phase_serve_prefix`` holds across its arms, from each arm's
    record: every request served in full (``max_new`` tokens, or ending at
    EOS) without an error; the async arms give the sync prefix arm's
    tokens, and arm c its per-request prefill and decode step sequences;
    the prefix arms b and c hit at least 4 times, save iterations and spend
    fewer prefill iterations than the cold arm a; arm c launches every
    serve-path kernel and no arm an off-path one; arm c's loop counts no
    blocking read; and in arm c a Broyden solve at the prefill shape with a
    warm ring (some row entered with a count > 0) launched
    ``broyden_step``."""
    for name, a in arms.items():
        for uid, (out, err) in enumerate(zip(a["tokens"], a["errors"])):
            full = len(out) == a["max_new"] or (out and out[-1] == a["eos"])
            if not full or err is not None:
                raise AssertionError(f"{name} request {uid}: {len(out)} "
                                     f"tokens, error {err}")
        off = {k: a["launches"][k] for k in OFF_PATH if a["launches"][k]}
        if off:
            raise AssertionError(f"{name} launched off-path kernels {off}")
    b, c = arms["b_sync_prefix"], arms["c_async_prefix"]
    for name in ASYNC_ARMS:
        for uid, (got, want) in enumerate(zip(arms[name]["tokens"],
                                              b["tokens"])):
            if got != want:
                raise AssertionError(f"{name} request {uid}: tokens {got}, "
                                     f"the sync prefix arm's {want}")
    if c["steps"] != b["steps"]:
        diff = {u: (c["steps"].get(u), s) for u, s in b["steps"].items()
                if c["steps"].get(u) != s}
        raise AssertionError(f"c_async_prefix step sequences differ from "
                             f"b_sync_prefix's (c, b): {diff}")
    for name in ("b_sync_prefix", "c_async_prefix"):
        a = arms[name]
        if not (a["hits"] >= 4 and a["saved_iters"] > 0
                and a["prefill_iters"] < arms["a_sync"]["prefill_iters"]):
            raise AssertionError(
                f"{name}: {a['hits']} hits, {a['saved_iters']} saved, "
                f"{a['prefill_iters']} prefill iterations against the cold "
                f"arm's {arms['a_sync']['prefill_iters']}")
    missing = [k for k in SERVE_PATH if c["launches"][k] == 0]
    if missing:
        raise AssertionError(f"c_async_prefix: kernels not launched: "
                             f"{missing}")
    if c["host_syncs"]:
        raise AssertionError(f"c_async_prefix counted blocking reads "
                             f"{c['host_syncs']}")
    if not any(w["broyden_step"] and max(w["counts"]) > 0
               for w in c["prefill_solves"]):
        raise AssertionError(f"c_async_prefix: no prefill-shaped "
                             f"broyden_step with a warm ring: "
                             f"{c['prefill_solves']}")


def _serve_prefix_arm(params, cfg, prompts: list, kw: dict) -> tuple:
    """One drain of ``prompts`` (16 new tokens each) through a fresh
    ``ServeLoop(**kw)``, with the metrics registry and launch counts reset
    just before, the host waits counted (``count_syncs``) and the
    prefill-shaped solves recorded; returns the loop, the requests, the
    seconds, the waits, the launch counts and the prefill solves."""
    loop = ServeLoop(params, cfg, slots=4, max_len=1024, **kw)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=16)
            for i, p in enumerate(prompts)]
    obs_metrics.default_registry().reset()
    syncs, solves = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    with count_syncs(syncs), _record_prefill_solves(solves):
        loop.drain(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches.counts()
    for w in solves:
        w["counts"] = [] if w["counts"] is None else w["counts"].tolist()
    return loop, reqs, secs, syncs, counts, solves


TIMING_ORDER = ("b_sync_prefix", "c_async_prefix", "c_async_prefix",
                "b_sync_prefix")


def prefix_timing(params, cfg, prompts: list, ref: dict) -> list:
    """Sync against async like for like: arms b and c again without record
    mode (whose sync arm reads every tick's logits), in the order
    ``TIMING_ORDER``; each must serve every request with ``ref``'s tokens,
    and the async runs must wait only for the solver and the clock."""
    out = []
    for name in TIMING_ORDER:
        loop, reqs, secs, syncs, _, _ = _serve_prefix_arm(
            params, cfg, prompts, {**PREFIX_ARMS[name], "record": False})
        got = [r.out for r in reqs]
        if got != ref["tokens"] or any(r.error for r in reqs):
            raise AssertionError(f"{name} without record mode: tokens "
                                 f"{got}, the record run's {ref['tokens']}")
        if name in ASYNC_ARMS:
            check_syncs(f"{name} without record mode", syncs,
                        async_expected_syncs(loop.solve_log,
                                             cfg.deq.max_steps))
        ttft = obs_metrics.default_registry().histogram("serve_ttft_ms")
        out.append(dict(arm=name, seconds=secs,
                        tok_per_s=sum(len(t) for t in got) / secs,
                        ttft_ms_mean=ttft.sum / ttft.count,
                        ttft_ms_max=ttft.max, host_waits=len(syncs)))
    return out


def phase_serve_prefix(params, cfg, smi: str) -> dict:
    """The async pipeline and the prefix caches at full width, the arms of
    ``PREFIX_ARMS`` over ``prefix_stream``: (a) sync without a prefix
    cache, (b) sync with the host prefix index, (c) async (depth 2) with
    the device prefix store, (d) as (c) with admission reordering.  Holds
    ``check_prefix_arms`` and, in the async arms, exactly the solver's own
    host reads plus the one clock wait (``async_expected_syncs``); prints
    each arm's rate, TTFT, prefill iterations, host waits by site, peak
    memory and store bytes; then times b and c like for like
    (``prefix_timing``).  The solves stop at ``PREFIX_TOL``; first the
    residual a cold prefill of the four bases levels off at
    (``residual_floor``).  Returns arm c's launch counts."""
    prompts = prefix_stream(cfg.vocab_size)
    floor = residual_floor(params, cfg, prompts[:4])
    say("serve_prefix_floor", card=smi, prompts="4 x 128, cold, no stop test",
        relative_residual=[float(f"{r:.4g}") for r in floor])
    cfg = dataclasses.replace(cfg, deq=dataclasses.replace(cfg.deq,
                                                           tol=PREFIX_TOL))
    arms = {}
    for name, kw in PREFIX_ARMS.items():
        loop, reqs, secs, syncs, counts, solves = _serve_prefix_arm(
            params, cfg, prompts, kw)
        reg = obs_metrics.default_registry()
        ttft = reg.histogram("serve_ttft_ms")
        host_syncs = {dict(m["labels"])["site"]: m["value"]
                      for m in reg.snapshot()["metrics"]
                      if m["name"] == "host_syncs_total"}
        cache = loop.prefix if loop.prefix is not None else loop.prefix_store
        stats = cache.stats() if cache is not None else None
        pf = [s["steps"] for s in loop.solve_log if s["phase"] == "prefill"]
        waits = dict(collections.Counter(syncs))
        if name in ASYNC_ARMS:
            waits = check_syncs(f"{name} drain", syncs, async_expected_syncs(
                loop.solve_log, cfg.deq.max_steps))
        arms[name] = dict(
            tokens=[r.out for r in reqs], errors=[r.error for r in reqs],
            max_new=16, eos=loop.eos, steps=loop.recorded_steps,
            hits=stats["hits"] if stats else 0,
            saved_iters=loop.saved_iters, prefill_iters=sum(pf),
            launches=counts, host_syncs=host_syncs,
            prefill_solves=solves)
        say("serve_prefix", arm=name, card=smi, tol=PREFIX_TOL,
            pipeline=kw["pipeline"], seconds=secs,
            tok_per_s=sum(len(r.out) for r in reqs) / secs,
            ttft_ms_mean=ttft.sum / ttft.count, ttft_ms_max=ttft.max,
            prefill_steps=pf, prefill_iters=sum(pf),
            loop_prefill_iters=loop.prefill_iters,
            saved_iters=loop.saved_iters, prefix_stats=stats,
            host_syncs_total=host_syncs, engine_waits=waits,
            decode_steps=[s["steps"] for s in loop.solve_log
                          if s["phase"] == "decode"],
            prefill_solves=[{k: w[k] for k in ("rows", "seq", "steps",
                                               "counts", "broyden_step")}
                            for w in solves],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            store_bytes=(loop.prefix_store.nbytes()
                         if loop.prefix_store is not None else None),
            launches={k: n for k, n in counts.items() if n})
        # the next arm's peak must not hold this arm's store
        del loop, cache
        torch.cuda.empty_cache()
    check_prefix_arms(arms)
    timing = prefix_timing(params, cfg, prompts, arms["b_sync_prefix"])
    say("serve_prefix_timing", card=smi, tol=PREFIX_TOL,
        order=[t["arm"] for t in timing], runs=timing)
    say("serve_prefix_checks", card=smi, passed=(
        "all requests served in full, no errors; c and d give b's tokens, c "
        "b's step sequences; b and c: hits >= 4, saved > 0, fewer prefill "
        "iterations than a; c: every serve-path kernel, a warm-ring "
        "prefill broyden_step, 0 counted blocking reads; c and d: host "
        "waits = the solver's reads + 1 clock wait; no off-path launch"))
    obs_metrics.default_registry().reset()
    return arms["c_async_prefix"]["launches"]


def _profile_window(fn, host_ops: bool = True) -> dict:
    """Run ``fn`` under torch.profiler: wall time, device busy time (sum of
    kernel self time on the one stream), idle share and the top kernels.
    ``host_ops`` False traces the device alone (a window of many host ops,
    whose trace would take longer to read than the window to run)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "kernel_launches": sum(e.count for e in kern),
            "top_kernels": [(e.key[:60], e.self_device_time_total / 1e3,
                             e.count) for e in top]}


def phase_profile(params, cfg, smi: str) -> None:
    """A traced window at full width, apart from the measured drain: the
    first tick admits 4 prompts of 256 tokens (one batched prefill) and
    decodes once; the second tick only decodes."""
    rng = np.random.default_rng(1)
    loop = ServeLoop(params, cfg, slots=4, max_len=1024)
    for i in range(4):
        loop.submit(Request(uid=100 + i, max_new_tokens=8,
                            prompt=rng.integers(2, cfg.vocab_size,
                                                size=256).tolist()))
    for tag in ("prefill_tick", "decode_tick"):
        prof = _profile_window(loop.step)
        say("profile", window=tag, config=cfg.name, card=smi,
            solves=[(s["phase"], s["steps"]) for s in loop.solve_log], **prof)
        loop.solve_log.clear()


# ---------------------------------------------------------------------------
# phase 6: train at the full width of MiniCPM-2B
# ---------------------------------------------------------------------------


def phase_train(params, cfg, smi: str) -> dict:
    """4 AdamW steps through ``Trainer`` (the ``DEQSettings`` defaults: 12
    Broyden steps to tol 1e-3, bf16 ring of 8, shine_fallback backward),
    batch 4 x 256 synthetic tokens, metrics on; one host read of the
    metrics per step, and no other host wait than the solver's
    (``count_syncs``, ``expected_syncs``); one more step with metrics off,
    held to the same count.  Then one profiled train step, and the
    trajectory check (``hold_trajectory``) against the plain attention."""
    with metrics_on():
        counts = _phase_train(params, cfg, smi)
    # a metrics-off step makes the same host waits: the bridge reads nothing
    tcfg = TrainConfig(steps=1, global_batch=4, seq_len=256,
                       schedule=cfg.schedule)
    syncs, fwd, seen = [], [], []
    with count_syncs(syncs), _record_forward(fwd):
        Trainer(cfg, tcfg, params=params).run(
            make_lm_batch_iterator(cfg, 4, 256, seed=0, device="cuda"),
            steps=1, log_every=1, on_metrics=lambda i, m: seen.append(m))
    waits = check_syncs("Broyden train step (metrics off)", syncs,
                        expected_syncs([n for n, _ in fwd],
                                       cfg.deq.max_steps, 1))
    say("train_host_waits", metrics="off", forward_steps=[n for n, _ in fwd],
        host_waits=waits, loss=seen[0]["loss"], card=smi)
    return counts


def _phase_train(params, cfg, smi: str) -> dict:
    nsteps, bsz, seq = 4, 4, 256
    tcfg = TrainConfig(steps=nsteps, global_batch=bsz, seq_len=seq,
                       schedule=cfg.schedule)
    trainer = Trainer(cfg, tcfg, params=params)
    reg = obs_metrics.default_registry()
    est = {"estimator": cfg.deq.backward}
    fb = reg.counter("backward_fallbacks_total", est)
    n_est = reg.counter("backward_estimates_total", est)
    n_est0 = n_est.value
    log = []
    mark = {"t": 0.0, "fb": fb.value}

    def on_metrics(i, m):
        now = time.perf_counter()
        log.append(dict(step=i, loss=m["loss"], grad_norm=m["grad_norm"],
                        lr=m["lr"], forward_steps=m["deq_steps"],
                        fallback_rows=fb.value - mark["fb"],
                        skipped=m["update_skipped"],
                        step_ms=(now - mark["t"]) * 1e3,
                        peak_mem_gib=torch.cuda.max_memory_allocated()
                        / 2 ** 30))
        mark.update(t=now, fb=fb.value)

    batches = make_lm_batch_iterator(cfg, bsz, seq, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    syncs = []
    mark["t"] = t0 = time.perf_counter()
    with count_syncs(syncs):
        state = trainer.run(batches, steps=nsteps, log_every=1,
                            on_metrics=on_metrics)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches.counts()
    waits = check_syncs("Broyden train steps (metrics on)", syncs,
                        expected_syncs([r["forward_steps"] for r in log],
                                       cfg.deq.max_steps, nsteps))
    say("train_host_waits", metrics="on", steps=nsteps, host_waits=waits,
        card=smi)
    for row in log:
        say("train_step", card=smi, **row)
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
                and row["skipped"] == 0.0):
            raise AssertionError(f"train step {row['step']}: {row}")
    if int(state.step) != nsteps:
        raise AssertionError(f"trainer stopped at step {int(state.step)}")
    backwards = n_est.value - n_est0
    if backwards != nsteps:
        raise AssertionError(f"{backwards} {cfg.deq.backward} backward "
                             f"passes in {nsteps} steps")
    say("train", config="minicpm-2b DEQ (d=2304, 36x64 heads, ff=5760, "
        "vocab 122753, 4 blocks x0.3, bf16, ring bf16 m=8), AdamW, "
        f"batch {bsz} x {seq}", backward=cfg.deq.backward,
        backward_passes=backwards, seconds=secs, card=smi,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    say("train_launches", total=counts,
        per_step={k: n / nsteps for k, n in counts.items()})
    missing = [k for k in TRAIN_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: "
                             f"{missing}")

    step_fn = train_steps.build_train_step(cfg, tcfg)
    batch = next(batches)
    prof = _profile_window(lambda: step_fn(state, batch))
    say("profile", window="train_step", card=smi, **prof)

    # the same 4 steps with the attention forward through its plain version
    # (on the card): how far the trajectory moves with the rounding of the
    # attention probabilities alone (the kernel rounds the unnormalised
    # ones to bf16, the plain version the normalised ones)
    def plain_attention(q, k, v, kv_length=None, *, causal=True, scale=None):
        return ref.attention_ref(q, k, v, causal=causal, kv_length=kv_length,
                                 scale=scale)

    plain, recorded, replay = [], [], []

    def on_arm(rows):
        def on(i, m):
            rows.append((m["deq_steps"], m["loss"], m["grad_norm"],
                         fb.value - mark["fb"]))
            mark["fb"] = fb.value
        return on

    def run(on):
        mark["fb"] = fb.value
        Trainer(cfg, tcfg, params=params).run(
            make_lm_batch_iterator(cfg, bsz, seq, seed=0, device="cuda"),
            steps=nsteps, log_every=1, on_metrics=on)

    with mock.patch.object(cuda_fa, "flash_attention", plain_attention):
        run(on_arm(plain))
    again = []
    with _record_solves(recorded):  # the kernel arm again, its solves kept
        run(on_arm(again))
    kern = [(r["forward_steps"], r["loss"], r["grad_norm"],
             r["fallback_rows"]) for r in log]
    if again != kern:  # every kernel is deterministic
        raise AssertionError(f"the kernel arm ran twice: {kern} then {again}")
    # the plain attention again, each forward solve answered with the
    # kernel arm's: both arms take their gradients at the same iterates
    with mock.patch.object(cuda_fa, "flash_attention", plain_attention), \
            _replay_solves(recorded):
        run(on_arm(replay))
    rel = hold_trajectory(kern, plain, replay)
    say("train_plain_attention", card=smi, kernel=kern, plain=plain,
        plain_at_kernel_iterates=replay, rel_diff=rel, tol=TRAJECTORY_TOL)
    return counts


TRAJECTORY_TOL = ("against the plain attention: the same forward steps and "
                  "fallback rows and loss rtol 1e-2 at every step; with the "
                  "kernel arm's forward solves replayed into the plain arm, "
                  "the same again and grad norm rtol 5e-2 at every step")


def _clone(x):
    """A deep copy of a solve's result: its tensors cloned, its named
    tuples, dataclasses, dicts and lists rebuilt around the copies."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(y) for y in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _clone(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _clone(y) for k, y in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(y) for y in x)
    return x


@contextlib.contextmanager
def _record_solves(out: list):
    """Keep a copy of the result of every forward solve
    (``implicit.solvers.broyden_solve``) made inside the block."""
    orig = implicit_solvers.broyden_solve

    def recorded(*args, **kwargs):
        res = orig(*args, **kwargs)
        out.append(_clone(res))
        return res

    with mock.patch.object(implicit_solvers, "broyden_solve", recorded):
        yield


@contextlib.contextmanager
def _replay_solves(results: list):
    """Answer the forward solves made inside the block, in order, with
    ``results`` (from :func:`_record_solves`) instead of solving; each must
    start from an iterate of the recorded one's shape, and every result
    must be used."""
    left = list(results)

    def replayed(g, z0, cfg, **kwargs):
        if not left:
            raise AssertionError("more forward solves than were recorded")
        res = left.pop(0)
        if res.z.shape != z0.shape:
            raise AssertionError(f"replayed solve of {tuple(res.z.shape)} "
                                 f"for an iterate of {tuple(z0.shape)}")
        return res

    with mock.patch.object(implicit_solvers, "broyden_solve", replayed):
        yield
    if left:
        raise AssertionError(f"{len(left)} recorded forward solves unused")


def hold_trajectory(kern, plain, replay) -> dict:
    """Hold the kernel arm's train steps ``(forward steps, loss, grad norm,
    fallback rows)`` to TRAJECTORY_TOL: to the plain-attention arm's
    (``plain``), and to the plain-attention arm's with each forward solve
    replaced by the kernel arm's result (``replay``).  A forward solve that
    does not settle returns each row's least-residual iterate, a pick that
    last-bit rounding can move, and the gradient taken there moves with it;
    with the solves replayed both arms take their gradients at the same
    iterates, at every step.  Returns the relative loss and grad-norm
    differences per step, by arm."""
    if not len(kern) == len(plain) == len(replay):
        raise AssertionError(f"{len(kern)} kernel steps, {len(plain)} plain "
                             f"steps, {len(replay)} replayed steps")
    rel = {"plain": [], "replay": []}
    for i, a in enumerate(kern):
        for arm, b in (("plain", plain[i]), ("replay", replay[i])):
            dl = abs(a[1] - b[1]) / abs(b[1])
            dg = abs(a[2] - b[2]) / abs(b[2])
            rel[arm].append((dl, dg))
            if a[0] != b[0] or a[3] != b[3] or dl > 1e-2 \
                    or (arm == "replay" and dg > 5e-2):
                raise AssertionError(
                    f"train step {i + 1}: kernel {a} strays from the "
                    f"{arm} arm's {b} ({TRAJECTORY_TOL})")
    return rel


def phase_refine_carry(params, cfg, smi: str) -> None:
    """``deq_carry="full"`` hands the forward solve the carried ring, which
    the solve extends in place and returns as the new carry (and as the
    ``H`` the backward reads).  A ``shine_refine`` backward warm-starts its
    adjoint solve from ``H^T``: it must work on a copy and leave the
    carry's ring, bit for bit, as the forward left it."""
    cfg = dataclasses.replace(cfg, deq=dataclasses.replace(
        cfg.deq, backward="shine_refine"))
    bsz, seq = 4, 256
    toks = torch.from_numpy(SyntheticTokenDataset(cfg.vocab_size, 5).batch(
        0, bsz, seq + 1)).cuda()
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    carry = lm.deq_solve_carry(cfg, bsz, seq, "cuda")
    with torch.no_grad():  # a first solve fills the carried chain
        carry = lm.loss_fn(params, batch, cfg, carry=carry)[1]["solve_carry"]
    leaves = _map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = lm.loss_fn(leaves, batch, cfg, carry=carry)
    new = metrics["solve_carry"].lowrank
    snap = (new.u.clone(), new.v.clone(), new.count.clone())
    launches.reset()
    loss.backward()
    torch.cuda.synchronize()
    counts = launches.counts()
    same = (torch.equal(new.u, snap[0]) and torch.equal(new.v, snap[1])
            and torch.equal(new.count, snap[2]))
    if not same:
        raise AssertionError("the refine backward changed the carry's ring")
    if counts["broyden_step"] == 0:
        raise AssertionError("the refine backward ran no adjoint Broyden "
                             "step on the card")
    say("refine_carry", backward="shine_refine", deq_carry="full",
        ring_unchanged=same, carried_count=snap[2].tolist(),
        forward_steps=metrics["deq_steps"],
        backward_launches={k: n for k, n in counts.items() if n}, card=smi)


def phase_skip_carry(params, cfg, smi: str) -> None:
    """``deq_carry="full"`` with ``skip_nonfinite``: a step that the
    non-finite check rejects must give back the pre-step carry bit for bit.
    The solver's guard is off here: with it on, its entry repair selects
    the carried ring into new buffers, while without it the solve extends
    the carried ring in place and only the step's copy keeps it.  One good
    step fills the ring; a NaN final-norm scale then makes the next step's
    loss NaN after its solve has run."""
    cfg = dataclasses.replace(cfg, deq=dataclasses.replace(cfg.deq,
                                                           guard=False))
    bsz, seq = 4, 256
    tcfg = TrainConfig(steps=2, global_batch=bsz, seq_len=seq,
                       deq_carry="full", skip_nonfinite=True)
    state = train_steps.init_train_state(cfg, tcfg, params=params)
    step = train_steps.build_train_step(cfg, tcfg)
    toks = torch.from_numpy(SyntheticTokenDataset(cfg.vocab_size, 6).batch(
        0, bsz, seq + 1)).cuda()
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    state, m = step(state, batch)
    if float(m["update_skipped"]) != 0.0:
        raise AssertionError("the first (finite) step was rejected")
    before, z = state.carry.lowrank.clone(), state.carry.z.clone()
    nan_norm = _map(lambda t: torch.full_like(t, float("nan")),
                    state.params["final_norm"])
    state = state._replace(params=dict(state.params, final_norm=nan_norm))
    launches.reset()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    counts = launches.counts()
    after = state.carry.lowrank
    same = (torch.equal(after.u, before.u) and torch.equal(after.v, before.v)
            and torch.equal(after.count, before.count)
            and torch.equal(state.carry.z, z))
    if float(m["update_skipped"]) != 1.0 or not same \
            or counts["broyden_step"] == 0:
        raise AssertionError(f"rejected step: skipped {m['update_skipped']}"
                             f", carry unchanged {same}, solve launches "
                             f"{counts['broyden_step']}")
    say("skip_carry", deq_carry="full", skip_nonfinite=True, guard=False,
        update_skipped=float(m["update_skipped"]), carry_unchanged=same,
        carried_count=before.count.tolist(),
        forward_steps=float(m["deq_steps"]),
        step_launches={k: n for k, n in counts.items() if n}, card=smi)


FULL_WIDTH_SOLVERS = ("adjoint_broyden", "anderson")


@contextlib.contextmanager
def _record_forward(out: list):
    """Keep ``(n_steps, per-row status)`` of every forward solve made inside
    the block (``implicit.fixed_point.solve_forward``), without a host
    read: the statuses stay on the card until the caller reads them."""
    orig = implicit_fp.solve_forward

    def recorded(*args, **kwargs):
        res = orig(*args, **kwargs)
        out.append((res.n_steps, res.status.clone()))
        return res

    with mock.patch.object(implicit_fp, "solve_forward", recorded):
        yield


TRAIN_PHASES = ("forward_solve", "implicit_backward", "optimizer")


def check_trace_phases(trace: dict, phases=TRAIN_PHASES) -> list[dict]:
    """Hold a Chrome trace of ``Trainer`` steps to the tracer's contract:
    the X events recorded inside each ``train_step`` span are ``phases``,
    in order, and tile it: the first starts at the span's start, each next
    one where the previous one ended, no duration is negative, and the last
    ends no later than the span.  Spans are matched to their phases by
    recording order, since the host may open the next step's span before
    the card has finished this one.  Returns each step's durations (ms)."""
    steps, cur = [], None
    for e in trace["traceEvents"]:
        if e["name"] == "train_step" and e["ph"] == "B":
            cur = {"B": e, "X": []}
        elif cur is not None and e["ph"] == "X":
            cur["X"].append(e)
        elif cur is not None and e["name"] == "train_step" \
                and e["ph"] == "E":
            steps.append(dict(cur, E=e))
            cur = None
    if not steps or cur is not None:
        raise AssertionError(f"trace: {len(steps)} closed train_step spans"
                             f"{', one left open' if cur else ''}")
    out = []
    for i, st in enumerate(steps):
        b, e, xs = st["B"]["ts"], st["E"]["ts"], st["X"]
        names = [x["name"] for x in xs]
        if names != list(phases):
            raise AssertionError(f"train_step {i}: phases {names}, want "
                                 f"{list(phases)}")
        at = b
        for x in xs:
            if x["dur"] < 0 or abs(x["ts"] - at) > 1e-3:
                raise AssertionError(
                    f"train_step {i}: {x['name']} spans [{x['ts']}, "
                    f"+{x['dur']}] us, not from the boundary at {at} us")
            at = x["ts"] + x["dur"]
        if at > e + 1e-3:
            raise AssertionError(f"train_step {i}: phases end at {at} us, "
                                 f"after the span's end at {e} us")
        out.append({"train_step": (e - b) / 1e3,
                    **{x["name"]: x["dur"] / 1e3 for x in xs}})
    return out


SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def count_syncs(out: list):
    """Note in ``out`` each host wait on the card issued inside the block:
    the explicit ones (``torch.cuda.synchronize`` and the event's and
    stream's ``synchronize``) and the implicit ones, which
    ``torch.cuda.set_sync_debug_mode("warn")`` reports as warnings: a read
    of a card tensor (``int()``, ``float()``, ``bool()``, ``.item()``,
    ``.tolist()``, ``.cpu()``), a copy from pageable host memory,
    ``nonzero`` and masked indexing.  An implicit one is noted with the
    ``file:line`` that made it; an explicit call is counted once (its own
    warning, if any, is not).  Without a card there is nothing to set:
    only the explicit calls and warnings raised by hand are noted."""
    card = torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if card else None
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.ExitStack() as stack:
        warnings.simplefilter("always")
        for owner, label in ((torch.cuda, "torch.cuda"),
                             (torch.cuda.Event, "Event"),
                             (torch.cuda.Stream, "Stream")):
            orig = getattr(owner, "synchronize")

            def counted(*a, _orig=orig, _label=label, **kw):
                out.append(f"{_label}.synchronize")
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    return _orig(*a, **kw)

            stack.enter_context(mock.patch.object(owner, "synchronize",
                                                  counted))
        if card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(prev)
    for w in caught:
        if SYNC_WARNING in str(w.message):
            out.append(f"implicit at {os.path.relpath(w.filename, ROOT)}:"
                       f"{w.lineno}")
        else:  # not ours: shown as it would have been
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)


def expected_syncs(forward_steps, max_steps: int, reads: int) -> int:
    """The host waits a train run makes: per forward solve, the solver's
    two reads per iteration (``bool(done.all())`` at the top of each,
    ``bool(do_rs.any())`` after the guard) and one more when the solve
    stops before its budget (the top check that ends it); then ``reads``,
    the trainer's one read per log interval, which also lands what the
    metrics bridge holds.  Nothing else: the backward, the optimizer, the
    bridge and the tracer read nothing."""
    return sum(2 * int(n) + (int(n) < max_steps)
               for n in forward_steps) + reads


def check_syncs(name: str, syncs: list, want: int) -> dict:
    """``syncs`` must hold exactly ``want`` host waits; the message names
    the sites of the ones counted."""
    if len(syncs) != want:
        raise AssertionError(
            f"{name}: {len(syncs)} host waits on the card, want {want}: "
            f"{dict(collections.Counter(syncs))}")
    return dict(collections.Counter(syncs))


@contextlib.contextmanager
def metrics_on():
    """The metrics bridge on inside the block (the fallback-row and
    backward counts the phases read come through it), off after."""
    obs_metrics.set_enabled(True)
    try:
        yield
    finally:
        obs_metrics.default_registry().flush()
        obs_metrics.set_enabled(False)


def traced_train_steps(trainer, batches, steps: int, *,
                       log_every: int | None = None,
                       forward: list | None = None) -> tuple[dict, list]:
    """``steps`` steps of ``trainer`` with span tracing on and one metrics
    read every ``log_every`` steps (default: one at the end), as
    ``--trace-out`` runs them: the Chrome trace, written to a file and read
    back, and the host waits on the card issued during the steps
    (``count_syncs``; the trace's own resolution at ``write`` comes after).
    ``forward`` receives each forward solve's ``(n_steps, status)``."""
    syncs = []
    obs_tracing.clear()
    obs_tracing.set_enabled(True)
    try:
        with count_syncs(syncs), _record_forward(
                [] if forward is None else forward):
            trainer.run(batches, steps=steps, log_every=log_every or steps,
                        on_metrics=lambda i, m: None)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            obs_tracing.write(path)
            with open(path) as fh:
                trace = json.load(fh)
    finally:
        obs_tracing.set_enabled(False)
        obs_tracing.clear()
    return trace, syncs


def phase_train_solvers(params, cfg, smi: str) -> dict:
    """2 AdamW steps of batch 4 x 256 at full width with each of
    FULL_WIDTH_SOLVERS as the forward solver (the other ``DEQSettings``
    defaults, ``shine_fallback`` backward; the weights of ``phase_train``),
    launch counts reset just before each arm and read just after, then one
    profiled step.  Fails on a non-finite loss, on an adjoint-Broyden arm
    that launched no ``qn_apply_multi``, on any launch of an OFF_PATH
    kernel, and on any host wait besides the solver's and the interval
    reads (``expected_syncs``), untraced with metrics on and traced with
    metrics off.  Returns each arm's launch counts."""
    nsteps, bsz, seq = 2, 4, 256
    reg = obs_metrics.default_registry()
    out = {}
    for solver in FULL_WIDTH_SOLVERS:
        scfg = dataclasses.replace(cfg, deq=dataclasses.replace(
            cfg.deq, solver=solver))
        tcfg = TrainConfig(steps=nsteps, global_batch=bsz, seq_len=seq,
                           schedule=cfg.schedule)
        fb = reg.counter("backward_fallbacks_total",
                         {"estimator": scfg.deq.backward})
        log, statuses = [], []
        mark = {"t": 0.0, "fb": fb.value}

        def on_metrics(i, m):
            now = time.perf_counter()
            log.append(dict(step=i, loss=m["loss"], grad_norm=m["grad_norm"],
                            forward_steps=m["deq_steps"],
                            fallback_rows=fb.value - mark["fb"],
                            skipped=m["update_skipped"],
                            step_ms=(now - mark["t"]) * 1e3))
            mark.update(t=now, fb=fb.value)

        batches = make_lm_batch_iterator(scfg, bsz, seq, seed=0,
                                         device="cuda")
        trainer = Trainer(scfg, tcfg, params=params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        mark["t"] = time.perf_counter()
        syncs = []
        with metrics_on(), count_syncs(syncs), _record_forward(statuses):
            state = trainer.run(batches, steps=nsteps, log_every=1,
                                on_metrics=on_metrics)
        torch.cuda.synchronize()
        counts = launches.counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        max_steps = scfg.deq.max_steps
        untraced = check_syncs(
            f"{solver} steps (metrics on)", syncs,
            expected_syncs([n for n, _ in statuses], max_steps, nsteps))
        for row, (_, st) in zip(log, statuses):
            row["statuses"] = st.tolist()
            say("train_solver_step", solver=solver, card=smi, **row)
            if not (np.isfinite(row["loss"])
                    and np.isfinite(row["grad_norm"])):
                raise AssertionError(f"{solver} train step {row['step']}: "
                                     f"{row}")
        if int(state.step) != nsteps or len(statuses) != nsteps:
            raise AssertionError(f"{solver}: {int(state.step)} steps, "
                                 f"{len(statuses)} forward solves")
        if solver == "adjoint_broyden" and counts["qn_apply_multi"] == 0:
            raise AssertionError("the adjoint-Broyden arm launched no "
                                 "qn_apply_multi")
        off = {k: counts[k] for k in OFF_PATH if counts[k]}
        if off:
            raise AssertionError(f"{solver} arm launched off-path kernels "
                                 f"{off}")
        # the same steps traced, with metrics off: the phases tile each
        # train_step span, and tracing adds no host wait: as many as the
        # untraced steps, the solver's and the interval reads
        fwd = []
        trace, syncs = traced_train_steps(trainer, batches, nsteps,
                                          log_every=1, forward=fwd)
        traced = check_syncs(
            f"{solver} traced steps (metrics off)", syncs,
            expected_syncs([n for n, _ in fwd], max_steps, nsteps))
        if [n for n, _ in fwd] == [n for n, _ in statuses] and \
                sum(traced.values()) != sum(untraced.values()):
            raise AssertionError(f"{solver}: traced {traced} vs untraced "
                                 f"{untraced} host waits")
        say("train_solver_trace", solver=solver, card=smi,
            host_waits_untraced=untraced, host_waits_traced=traced,
            steps_ms=check_trace_phases(trace))
        step_fn = train_steps.build_train_step(scfg, tcfg)
        batch = next(batches)
        prof = _profile_window(lambda: step_fn(state, batch))
        say("train_solver", solver=solver, backward=scfg.deq.backward,
            config="minicpm-2b DEQ full width, 4 blocks x0.3, bf16, "
            f"AdamW, batch {bsz} x {seq}", card=smi, peak_mem_gib=peak,
            launches=counts, launches_per_step={
                k: n / nsteps for k, n in counts.items()})
        say("profile", window=f"train_step[{solver}]", card=smi, **prof)
        out[solver] = counts
        # the next arm's peak must not hold this arm's parameters and
        # optimizer state
        del state, trainer, batches, step_fn, batch
    return out


# ---------------------------------------------------------------------------
# fault injection at full width (the chaos suite's classes on the card)
# ---------------------------------------------------------------------------


FAULTINJECT = "repro_torch.runtime.faultinject"
CHAOS_SEQS = (256, 1)   # the streaming (prefill) and resident (decode) qN schedules
CHAOS_FAULT_ROW, CHAOS_RING_ROW = 1, 2


def _solve_prefill(params, cfg, tokens, **kw) -> tuple:
    """One ``lm.prefill`` of ``tokens`` (no gradient): a copy of its forward
    solve's result and the prefill's outputs."""
    rec = []
    with torch.no_grad(), _record_solves(rec):
        out = lm.prefill(params, {"tokens": tokens}, cfg, tokens.shape[1],
                         **kw)
    if len(rec) != 1:
        raise AssertionError(f"{len(rec)} forward solves in one prefill")
    return rec[0], out


def check_rows_equal(name: str, got: tuple, want: tuple, rows) -> None:
    """Rows ``rows`` of the solve's iterate and of the logits of ``got``
    (a ``_solve_prefill`` return) bit for bit those of ``want``."""
    for r in rows:
        for what, a, b in (("iterate", got[0].z[r], want[0].z[r]),
                           ("logits", got[1][0][r], want[1][0][r])):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{name}: healthy row {r}'s {what} differs from the "
                    f"fault-free run's by {float((a - b).abs().max()):.3e}")


def _chaos_faults(fi, params, cfg, seq: int, gen) -> dict:
    """At ``B=4 x seq``: a ``nonfinite`` and a ``diverge`` fault at row
    CHAOS_FAULT_ROW from step 2 on (for ever), and a warm carry whose ring
    row CHAOS_RING_ROW is NaN.  The faulted row ends with the class's
    status and a finite best iterate (the NaN ring: a finite residual after
    its restart); every other row's iterate and logits are the fault-free
    run's bit for bit."""
    V = cfg.vocab_size
    toks = [torch.randint(2, V, (4, seq), device="cuda", generator=gen)
            for _ in range(2)]
    clean = _solve_prefill(params, cfg, toks[0])
    out = {}
    healthy = [r for r in range(4) if r != CHAOS_FAULT_ROW]
    for kind, code in (("nonfinite", core_solvers.STATUS_NONFINITE),
                       ("diverge", core_solvers.STATUS_DIVERGED)):
        with fi.inject(fi.FaultPlan(kind, sample=CHAOS_FAULT_ROW, step=2)):
            got = _solve_prefill(params, cfg, toks[0])
        st = got[0].status.tolist()
        if st[CHAOS_FAULT_ROW] != code or not bool(
                torch.isfinite(got[0].z[CHAOS_FAULT_ROW]).all()):
            raise AssertionError(f"chaos {kind} S={seq}: statuses {st}, "
                                 f"finite best iterate "
                                 f"{bool(torch.isfinite(got[0].z).all())}")
        check_rows_equal(f"chaos {kind} S={seq}", got, clean, healthy)
        out[kind] = dict(statuses=st, steps=got[0].n_steps,
                         clean_steps=clean[0].n_steps)
    # a warm carry: the first batch's converged state, then a second batch
    # started from it (the whole prompt seeded), once clean, once with a
    # NaN ring row
    cold = lm.deq_solve_carry(cfg, 4, seq, device="cuda")
    zeros = torch.zeros(4, dtype=torch.int32, device="cuda")
    full = torch.full((4,), seq, dtype=torch.int32, device="cuda")
    warm = _solve_prefill(params, cfg, toks[0], prefix_carry=cold,
                          prefix_len=zeros)[1][3]
    ref_run = _solve_prefill(params, cfg, toks[1],
                             prefix_carry=_clone(warm),
                             prefix_len=full)
    bad = fi.corrupt_carry_ring(_clone(warm), rows=[CHAOS_RING_ROW])
    got = _solve_prefill(params, cfg, toks[1], prefix_carry=bad,
                         prefix_len=full)
    res = got[0]
    st = res.status.tolist()
    ok = (st[CHAOS_RING_ROW] >= core_solvers.STATUS_DIVERGED
          and bool(torch.isfinite(res.z).all())
          and bool(torch.isfinite(res.residual[CHAOS_RING_ROW])))
    if not ok or ref_run[0].n_steps == 0:
        raise AssertionError(f"chaos ring S={seq}: statuses {st}, residual "
                             f"{res.residual.tolist()}, reference steps "
                             f"{ref_run[0].n_steps}")
    check_rows_equal(f"chaos ring S={seq}", got, ref_run,
                     [r for r in range(4) if r != CHAOS_RING_ROW])
    out["ring"] = dict(statuses=st, residual=res.residual.tolist(),
                       warm_counts=warm.lowrank.count.tolist())
    return out


def _chaos_store(fi, params, cfg) -> dict:
    """The async pipeline with the device prefix store (arm c of
    ``phase_serve_prefix``, 5 requests): two 128-token bases drained, then
    a repeat of each and a fresh prompt.  With base 0's store slot poisoned
    before the second drain, its repeat is retried cold and evicted with
    reason "poisoned", and the other two requests' tokens equal an
    unpoisoned drain's."""
    pcfg = dataclasses.replace(cfg, deq=dataclasses.replace(cfg.deq,
                                                           tol=PREFIX_TOL))
    rng = np.random.default_rng(5)
    bases = [rng.integers(2, cfg.vocab_size, size=128).tolist()
             for _ in range(2)]
    fresh = rng.integers(2, cfg.vocab_size, size=128).tolist()
    kw = dict(PREFIX_ARMS["c_async_prefix"], record=False)
    runs = {}
    reg = obs_metrics.default_registry()
    for poison in (False, True):
        loop = ServeLoop(params, pcfg, slots=4, max_len=1024, **kw)
        loop.drain([Request(uid=i, prompt=list(b), max_new_tokens=4)
                    for i, b in enumerate(bases)])
        slots = {}
        for e in loop.prefix_store._entries.values():
            for i, b in enumerate(bases):
                if tuple(b[:len(e.tokens)]) == tuple(e.tokens):
                    slots.setdefault(i, set()).add(e.slot)
        if set(slots) != {0, 1} or slots[0] & slots[1]:
            raise AssertionError(f"chaos store: base slots {slots}")
        if poison:
            for slot in slots[0]:
                fi.poison_prefix_store_slot(loop.prefix_store, slot)
        ev0 = reg.counter("prefix_cache_evictions_total",
                          {"reason": "poisoned"}).value
        reqs = [Request(uid=10 + i, prompt=list(p), max_new_tokens=8)
                for i, p in enumerate(bases + [fresh])]
        loop.drain(reqs)
        runs[poison] = dict(
            tokens=[r.out for r in reqs], retried=[r.retried for r in reqs],
            errors=[r.error for r in reqs],
            evicted=loop.prefix_store.evictions_by_reason["poisoned"],
            evicted_metric=reg.counter("prefix_cache_evictions_total",
                                       {"reason": "poisoned"}).value - ev0)
        del loop
    got, want = runs[True], runs[False]
    if not (got["retried"][0] and not any(got["retried"][1:])
            and got["errors"] == [None] * 3
            and all(len(t) == 8 for t in got["tokens"])
            and got["evicted"] >= 1 and got["evicted_metric"] >= 1):
        raise AssertionError(f"chaos store: {got}")
    if got["tokens"][1:] != want["tokens"][1:]:
        raise AssertionError(f"chaos store: the healthy requests' tokens "
                             f"{got['tokens'][1:]}, unpoisoned "
                             f"{want['tokens'][1:]}")
    return dict(poisoned=got, clean=want)


def phase_chaos(params, cfg, smi: str) -> None:
    """The chaos suite's fault classes at the full width of MiniCPM-2B
    (the weights of ``phase_serve``), through ``lm.prefill`` at B=4 x 256
    (the qN kernels' streaming schedule, whose slices straddle samples) and
    at B=4 x 1 (the resident schedule): ``_chaos_faults`` for each, then
    the poisoned prefix store in the async pipeline (``_chaos_store``).
    First a prefill with ``faultinject`` never imported; once it has been
    imported, armed and disarmed, the same prefill gives the same iterate
    bit for bit, the same launch counts and the same host waits."""
    if FAULTINJECT in sys.modules:
        raise AssertionError(f"{FAULTINJECT} imported before phase_chaos")
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(2, cfg.vocab_size, (4, 256), device="cuda",
                         generator=gen)

    def counted_prefill():
        syncs = []
        torch.cuda.synchronize()
        launches.reset()
        with count_syncs(syncs):
            run = _solve_prefill(params, cfg, toks)
        torch.cuda.synchronize()
        return run, launches.counts(), syncs

    before = counted_prefill()
    import importlib
    fi = importlib.import_module(FAULTINJECT)
    out = {f"S={seq}": _chaos_faults(fi, params, cfg, seq, gen)
           for seq in CHAOS_SEQS}
    with fi.inject(fi.FaultPlan("nonfinite", step=10 ** 6)):
        pass
    after = counted_prefill()
    if not torch.equal(after[0][0].z, before[0][0].z) or \
            after[1] != before[1] or len(after[2]) != len(before[2]):
        raise AssertionError(
            f"unarmed faultinject changed the prefill: launches {after[1]} "
            f"vs {before[1]}, host waits {len(after[2])} vs "
            f"{len(before[2])}")
    out["store"] = _chaos_store(fi, params, cfg)
    say("chaos", card=smi, config="minicpm-2b DEQ full width, 4 blocks "
        "x0.3, bf16, ring bf16 m=8", plans="FaultPlan(kind, sample=1, "
        "step=2), corrupt_carry_ring(rows=[2]), poison_prefix_store_slot",
        unarmed=dict(launches={k: n for k, n in before[1].items() if n},
                     host_waits=len(before[2])),
        **out, checked="faulted rows: the class's status, finite best "
        "iterate; every other row's iterate and logits bit for bit the "
        "fault-free run's, at S=256 (streaming) and S=1 (resident); the "
        "poisoned seed retried cold and evicted as poisoned, the other "
        "requests' tokens as unpoisoned; unarmed = never imported")


# ---------------------------------------------------------------------------
# the multiscale DEQ (the paper's CIFAR model) at MDEQConfig()
# ---------------------------------------------------------------------------


MDEQ_BATCH = 128     # cut from CIFAR's 50,000 training images
MDEQ_SGD_STEPS, MDEQ_LR = 8, 0.05
MDEQ_ALIGN = 0.5     # tests/test_mdeq.py::test_shine_vs_full_gradient_alignment
MDEQ_PARITY = dict(image_size=12, channels=(8, 16), max_steps=12, memory=12)
MDEQ_PARITY_TOL = 1e-4


def _leaves(tree: dict) -> list:
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _mdeq_grad(params, batch, cfg, deq_cfg):
    """``(loss, aux, grads)`` of ``mdeq_loss`` at ``params``."""
    leaves = _map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = mdeq.mdeq_loss(leaves, batch, cfg, deq_cfg)
    loss.backward()
    return loss.detach(), aux, _map(lambda t: t.grad, leaves)


def phase_mdeq(smi: str) -> dict:
    """``MDEQConfig()`` (32 x 32, channels 24/48, Broyden 18 steps, memory
    18, tol 1e-3) at batch MDEQ_BATCH of ``synthetic_cifar(seed=0)``,
    random weights (seed 0): a forward, held to the solver's host reads,
    then MDEQ_SGD_STEPS SGD steps with ``shine_fallback`` (the recipe of
    ``tests/test_mdeq.py::test_mdeq_trains_with_shine``), whose loss must
    fall, launch counts reset just before and read just after (both qN
    kernels must launch); one gradient each with ``full`` and
    ``shine_fallback`` (the recipe of its alignment test), cosine above
    MDEQ_ALIGN; then the parity config on the card and on the CPU: the same
    solver steps, logits within MDEQ_PARITY_TOL of their scale.  Returns
    the forward's and the SGD steps' launch counts."""
    cfg = MDEQConfig()
    params = mdeq.init_mdeq(cfg, seed=0, device="cuda")
    images, labels = mdeq.synthetic_cifar(MDEQ_BATCH, cfg, seed=0,
                                          device="cuda")
    batch = {"images": images, "labels": labels}
    syncs = []
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    with torch.no_grad(), count_syncs(syncs):
        logits, stats = mdeq.mdeq_forward(params, images, cfg)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd = launches.counts()
    waits = check_syncs("mdeq forward", syncs, expected_syncs(
        [stats.n_steps], cfg.max_steps, 0))
    if tuple(logits.shape) != (MDEQ_BATCH, cfg.num_classes) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"mdeq forward: logits {tuple(logits.shape)}")
    if fwd["broyden_step"] != stats.n_steps or fwd["qn_apply_multi"] < 1:
        raise AssertionError(f"mdeq forward: {stats.n_steps} steps, "
                             f"launches {fwd}")
    say("mdeq_forward", card=smi, config="MDEQConfig() (32x32, channels "
        f"24/48, Broyden 18 steps, memory 18, tol 1e-3, bf16 ring), batch "
        f"{MDEQ_BATCH}", steps=stats.n_steps,
        statuses=sorted(set(stats.status.tolist())),
        residual_mean=float(stats.residual.mean()), ms=fwd_ms,
        host_waits=waits, launches={k: n for k, n in fwd.items() if n})

    deq_cfg = DEQConfig(max_steps=cfg.max_steps, tol=cfg.tol,
                        memory=cfg.memory, backward="shine_fallback")
    p = params
    log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    for i in range(MDEQ_SGD_STEPS):
        t0 = time.perf_counter()
        loss, aux, grads = _mdeq_grad(p, batch, cfg, deq_cfg)
        p = _sgd(p, grads, MDEQ_LR)
        loss = float(loss)
        log.append(dict(step=i, loss=loss, forward_steps=aux["deq_steps"],
                        step_ms=(time.perf_counter() - t0) * 1e3))
    torch.cuda.synchronize()
    sgd = launches.counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [r["loss"] for r in log]
    missing = [k for k in ("broyden_step", "qn_apply_multi") if not sgd[k]]
    off = {k: sgd[k] for k in OFF_PATH if sgd[k]}
    if missing or off or not losses[-1] < losses[0] or not all(
            np.isfinite(losses)):
        raise AssertionError(f"mdeq SGD: losses {losses}, launches {sgd}")
    say("mdeq_train", card=smi, backward="shine_fallback", lr=MDEQ_LR,
        steps=log, peak_mem_gib=peak, launches=sgd,
        launches_per_step={k: n / MDEQ_SGD_STEPS for k, n in sgd.items()
                           if n})

    align = {}
    for backward in ("full", "shine_fallback"):
        dcfg = DEQConfig(max_steps=25, tol=1e-6, memory=25,
                         backward=backward, backward_max_steps=40,
                         backward_tol=1e-8)
        align[backward] = _leaves(_mdeq_grad(params, batch, cfg, dcfg)[2])
    num = sum(float((a * b).sum()) for a, b in zip(*align.values()))
    na, nb = (float(sum((x * x).sum() for x in g)) ** 0.5
              for g in align.values())
    cos = num / (na * nb)
    if not cos > MDEQ_ALIGN:
        raise AssertionError(f"mdeq: cos(full, shine_fallback) = {cos}")

    small = MDEQConfig(**MDEQ_PARITY)
    icfg = ImplicitConfig.from_strings(max_steps=12, tol=1e-3, memory=12,
                                       qn_dtype="float32")
    cpu_params = mdeq.init_mdeq(small, seed=1, device="cpu")
    imgs, _ = mdeq.synthetic_cifar(8, small, seed=0, device="cpu")
    with torch.no_grad():
        lc, sc = mdeq.mdeq_forward(cpu_params, imgs, small, icfg)
        lg, sg = mdeq.mdeq_forward(_map(lambda t: t.to("cuda"), cpu_params),
                                   imgs.to("cuda"), small, icfg)
    err = float((lg.cpu() - lc).abs().max())
    scale = float(lc.abs().max())
    if sg.n_steps != sc.n_steps or err > MDEQ_PARITY_TOL * max(scale, 1.0):
        raise AssertionError(f"mdeq parity: steps {sg.n_steps} vs "
                             f"{sc.n_steps}, logits differ by {err:.3e}")
    say("mdeq_checks", card=smi, grad_cosine_full_vs_shine_fallback=cos,
        bound=MDEQ_ALIGN, parity=dict(config=str(small), f32_ring=True,
                                      steps=sg.n_steps, max_abs_err=err,
                                      scale=scale, tol=MDEQ_PARITY_TOL))
    return {"forward": fwd, "sgd": sgd, "forward_steps": stats.n_steps}


def _sgd(params: dict, grads: dict, lr: float) -> dict:
    return {k: (_sgd(v, grads[k], lr) if isinstance(v, dict) else
                (v - lr * grads[k]).detach()) for k, v in params.items()}


# ---------------------------------------------------------------------------
# bi-level hyperparameter optimisation (HOAG with SHINE)
# ---------------------------------------------------------------------------


# real-sim's feature count; its 72,309 samples cut to 5000 / 1000 / 1000;
# the density of benchmarks/bench_bilevel.py's "realsim-like" problem
BILEVEL_PROBLEM = dict(n_train=5000, n_val=1000, n_test=1000, dim=20958,
                       density=0.15, seed=0)
# mode -> tol_decrease, as benchmarks/bench_bilevel.py's HOAG configs
BILEVEL_MODES = {"full_cg": 0.99, "shine": 0.78, "shine_opa": 0.78,
                 "jfb": 0.78}
BILEVEL_INNER = dict(max_steps=300, tol=1e-4, memory=30)
BILEVEL_OUTER = dict(outer_steps=8, outer_lr=20.0)
BILEVEL_THETA0 = 1.0
BILEVEL_REL = 0.5    # tests/test_bilevel.py::test_shine_hypergrad_matches_cg


@contextlib.contextmanager
def _count_line_search(out: list):
    """Note one entry in ``out`` per Armijo test (a value evaluation of
    ``core.solvers._line_search``) made inside the block."""
    orig = core_solvers._line_search

    def counted(value_fn, *a, **kw):
        def value(z):
            out.append(1)
            return value_fn(z)
        return orig(value, *a, **kw)

    with mock.patch.object(core_solvers, "_line_search", counted):
        yield


def hoag_expected_syncs(hist, ls_tests: int, hcfg) -> int:
    """The host waits of a ``run_hoag``: per outer step the inner L-BFGS
    solve's stop test per iteration (and one more when it stops before its
    budget), CG's per iteration (and one more when it stops early) where
    the mode runs CG, and the record's three scalars; plus one per
    line-search test over the run."""
    est, _ = bilevel.resolve_hoag_mode(hcfg.mode)
    cg_budget = {"full": hcfg.cg_steps, "shine_refine": hcfg.refine_steps,
                 "jfb_refine": hcfg.refine_steps}.get(est)
    n = ls_tests
    for r in hist:
        n += r.inner_steps + (r.inner_steps < hcfg.inner.max_steps) + 3
        if cg_budget is not None:
            k = r.backward_hvp_calls
            n += k + (k < cg_budget)
    return n


def phase_bilevel(smi: str) -> None:
    """``run_hoag`` on ``make_logreg_problem(**BILEVEL_PROBLEM)`` on the
    card, each mode of BILEVEL_MODES for BILEVEL_OUTER's steps from
    theta BILEVEL_THETA0: the validation loss falls in every mode, the
    shine modes make 0 backward HVP calls (full CG some), and the host
    waits are exactly ``hoag_expected_syncs``.  First, at theta0, the
    inner solve of step 0 and its hypergradient by CG, SHINE and JFB:
    SHINE's has CG's sign and is within BILEVEL_REL of it.  Plain PyTorch:
    the JAX package runs no Pallas kernel here either."""
    t0 = time.perf_counter()
    problem = bilevel.make_logreg_problem(**BILEVEL_PROBLEM, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    theta = torch.full((), BILEVEL_THETA0, device="cuda")
    res = core_solvers.lbfgs_solve(
        lambda z: problem.inner_grad(z, theta),
        torch.zeros(problem.dim, device="cuda"),
        core_solvers.SolverConfig(**BILEVEL_INNER),
        value_fn=lambda z: problem.inner_value(z, theta))
    hg = {m: float(bilevel.hypergradient(problem, theta, res.z, res.memory,
                                         bilevel.HOAGConfig(mode=m))[0])
          for m in ("full_cg", "shine", "jfb")}
    rel = {m: abs(hg[m] - hg["full_cg"]) / (abs(hg["full_cg"]) + 1e-12)
           for m in ("shine", "jfb")}
    if np.sign(hg["shine"]) != np.sign(hg["full_cg"]) or \
            not rel["shine"] < BILEVEL_REL:
        raise AssertionError(f"step-0 hypergradients {hg}")
    say("bilevel_hypergrad", card=smi, step0_inner_steps=res.n_steps,
        hypergrad=hg, rel_to_cg=rel, bound=BILEVEL_REL)
    runs = {}
    for mode, dec in BILEVEL_MODES.items():
        hcfg = bilevel.HOAGConfig(
            mode=mode, tol_decrease=dec,
            inner=core_solvers.SolverConfig(**BILEVEL_INNER),
            **BILEVEL_OUTER)
        syncs, ls = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_syncs(syncs), _count_line_search(ls):
            hist = bilevel.run_hoag(problem, BILEVEL_THETA0, hcfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        waits = check_syncs(f"hoag {mode}", syncs,
                            hoag_expected_syncs(hist, len(ls), hcfg))
        hvp = [r.backward_hvp_calls for r in hist]
        if not hist[-1].val_loss < hist[0].val_loss or (
                mode.startswith("shine") and any(hvp)) or (
                mode == "full_cg" and not any(hvp)):
            raise AssertionError(f"hoag {mode}: {hist}")
        inner = sum(r.inner_steps for r in hist)
        runs[mode] = dict(seconds=secs, val_loss=[r.val_loss for r in hist],
                          theta=[r.theta for r in hist],
                          test_loss=hist[-1].test_loss,
                          inner_steps=[r.inner_steps for r in hist],
                          backward_hvp_calls=hvp, line_search_tests=len(ls),
                          host_waits=sum(waits.values()),
                          host_waits_per_inner_iteration=(
                              (inner + len(ls)) / max(inner, 1)))
        say("bilevel", card=smi, mode=mode, **runs[mode])
    say("bilevel_summary", card=smi, problem=BILEVEL_PROBLEM,
        setup_seconds=setup_s, outer=BILEVEL_OUTER, inner=BILEVEL_INNER,
        theta0=BILEVEL_THETA0,
        seconds={m: r["seconds"] for m, r in runs.items()},
        host_waits={m: r["host_waits"] for m, r in runs.items()})


# ---------------------------------------------------------------------------
# phase 13: the layer stack with MLA and the fine-grained MoE
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_GQA_ARCH = "deepseek-v2-lite-16b", "deepseek-moe-16b"
MOE_PLENS = (128, 256, 128, 256)
MOE_MAX_LEN = 512
MOE_NEW = 16
CACHE_TOL = (dict(rtol=3e-2, atol=3e-2), dict(rtol=4e-2, atol=4e-2))
CACHE_SEEDS = (1, 2, 3, 4, 5)
# the cache check again at a cut depth (the dense layer and 3 MoE layers,
# full width), in bf16 and in f32 (at TOL_F32): how the bf16 error grows
# with depth, and that the cache path is exact to f32 rounding
CACHE_CUT_LAYERS = 4
# the card's MLA instance at smoke widths: the smoke qk (16 + 8 = 24) is no
# head dim the kernels instantiate, so the card-vs-CPU check runs 48 + 16
MLA_SMOKE_QK = dict(qk_nope_dim=48, qk_rope_dim=16)


def _moe_drain(params, cfg, pipeline: str, record: bool,
               plens=MOE_PLENS, max_len: int = MOE_MAX_LEN) -> dict:
    """One drain of ``plens`` prompts (MOE_PLENS) over 4 slots (MOE_NEW new
    tokens, a ``max_len`` cache) with the launch counts reset just before
    and the host waits counted; every request must be served in full with
    no fault (and, recorded, finite logits)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in plens]
    loop = ServeLoop(params, cfg, slots=4, max_len=max_len,
                     pipeline=pipeline, record=record)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MOE_NEW)
            for i, p in enumerate(prompts)]
    obs_metrics.default_registry().reset()
    syncs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    with count_syncs(syncs):
        loop.drain(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches.counts()
    for r in reqs:
        if len(r.out) != r.max_new_tokens or r.error is not None:
            raise AssertionError(f"{cfg.name} {pipeline} request {r.uid}: "
                                 f"{len(r.out)} tokens, error {r.error}")
        if record and not all(np.isfinite(x).all()
                              for x in loop.recorded_logits[r.uid]):
            raise AssertionError(f"{cfg.name} {pipeline} request {r.uid}: "
                                 f"non-finite logits")
    summ = serve_summary(loop, reqs, secs)
    return dict(tokens=[r.out for r in reqs], counts=counts, syncs=syncs,
                host_waits=dict(collections.Counter(syncs)),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                statuses=sorted({c for s in loop.solve_log
                                 for c in (s["status"] or [])}),
                solve_steps=[(s["phase"], s["steps"])
                             for s in loop.solve_log],
                **{k: summ[k] for k in ("tok_per_s", "ttft_ms_mean",
                                        "ttft_ms_max", "seconds",
                                        "prefill_calls")})


def _dropless(cfg):
    """``cfg`` with a capacity factor at which no expert drops a token (a
    config without experts as it is)."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def limit_share(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """Largest ``|got - want| / (atol + rtol * |want|)``: the share of its
    elementwise limit the worst element takes (> 1 is a miss)."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())
            ).max().item()


def check_cache_against_forward(params, cfg, bsz: int = 2,
                                seq: int = 128, tol=CACHE_TOL, *,
                                hold: bool = True,
                                leaves: bool = False) -> dict:
    """``tests/test_archs.py::test_prefill_decode_matches_forward`` at full
    width on the card, for each token seed of ``CACHE_SEEDS``: prefill over
    S tokens then one decode step against a full forward over S + 1 (last
    prefill logits at 3e-2, the decode step's at 4e-2, or ``tol``), in
    the config's dtype; each seed's largest error and share of the limit
    reported.  Dropless
    (``_dropless``): experts keep tokens first come first served in the
    flattened batch order, so S and S + 1 tokens would drop different
    ones.  The launch counts are the first seed's.  ``hold=False`` reports
    the readings without holding them to ``tol``, beside the rounding
    floor of the forward itself: each row forwarded alone against the
    batch's forward at positions S - 1 and S (the same arithmetic at
    another batch size, whose GEMMs may round in another order).
    ``leaves`` also holds the caches after the decode step against a
    prefill over S + 1, layer by layer (``check_cache_leaves``)."""
    cfg = _dropless(cfg)
    seeds, counts = {}, {}
    for seed in CACHE_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        toks = torch.randint(2, cfg.vocab_size, (bsz, seq + 1),
                             device="cuda", generator=gen)
        with torch.no_grad():
            full, _ = lm.forward(params, {"tokens": toks}, cfg,
                                 train=False)
        launches.reset()
        pre, caches, lens = lm.prefill(params, {"tokens": toks[:, :seq]},
                                       cfg, MOE_MAX_LEN)
        counts.setdefault("prefill", launches.counts())
        launches.reset()
        dec, _ = lm.decode_step(params, caches, toks[:, seq], lens, cfg)
        counts.setdefault("decode", launches.counts())
        row = seeds[seed] = {}
        if leaves:
            _, want_caches, _ = lm.prefill(params, {"tokens": toks}, cfg,
                                           MOE_MAX_LEN)
            row["leaves"] = check_cache_leaves(
                caches, want_caches, cfg, f"{cfg.name} {cfg.num_layers} "
                f"layers {cfg.dtype} (seed {seed})")
            del want_caches
        pairs = [("prefill", pre[:, -1], full[:, seq - 1], tol[0]),
                 ("decode", dec, full[:, seq], tol[1])]
        if not hold:
            with torch.no_grad():
                alone = torch.cat([lm.forward(params, {"tokens": toks[i:i + 1]},
                                              cfg, train=False)[0]
                                   for i in range(bsz)])
            pairs += [("noise_prefill", alone[:, seq - 1], full[:, seq - 1],
                       tol[0]),
                      ("noise_decode", alone[:, seq], full[:, seq], tol[1])]
        for tag, got, want, t in pairs:
            name = (f"{cfg.name} {cfg.num_layers} layers {cfg.dtype} {tag} "
                    f"vs forward (seed {seed})")
            row[tag] = dict(
                max_abs_err=(check_close(name, got, want, t) if hold else
                             (got.float() - want.float()).abs().max().item()),
                limit_share=limit_share(got, want, t),
                logit_scale=want.float().abs().max().item())
    return dict(batch=bsz, seq=seq, seeds=seeds, tol=tol, held=hold,
                capacity_factor=cfg.moe.capacity_factor,
                launches_per_prefill={k: n for k, n in counts["prefill"].items()
                                      if n},
                launches_per_decode={k: n for k, n in counts["decode"].items()
                                     if n})


def _named_leaves(tree, path: str = "") -> list:
    """``(path, tensor)`` for each leaf of a cache tree, in the order of
    ``serving.cache_leaves``."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{path}{k}.")]
    if isinstance(tree, tuple):
        return [x for k, v in zip(tree._fields, tree)
                for x in _named_leaves(v, f"{path}{k}.")]
    return [(path.rstrip("."), tree)]


def check_cache_leaves(got_tree, want_tree, cfg, name: str) -> dict:
    """Every layer's slice of every cache leaf (the axes before the batch
    axis index the layers) of ``got_tree`` against ``want_tree``'s, held
    at ``_scaled_tol`` of that slice's own largest entry: a layer's state
    is held whatever it adds to the residual stream.  Returns each leaf's
    largest error, largest share of its limit and largest scale over its
    layers."""
    out = {}
    for (path, got), (_, want), ax in zip(_named_leaves(got_tree),
                                          _named_leaves(want_tree),
                                          cache_batch_axes(cfg)):
        g, w = got.flatten(0, ax - 1), want.flatten(0, ax - 1)
        row = out[path] = dict(max_abs_err=0.0, limit_share=0.0, scale=0.0,
                               layers=g.shape[0])
        for i in range(g.shape[0]):
            tol = _scaled_tol(w[i])
            row["max_abs_err"] = max(row["max_abs_err"], check_close(
                f"{name} cache {path}[{i}] vs prefill over S + 1", g[i],
                w[i], tol))
            row["limit_share"] = max(row["limit_share"],
                                     limit_share(g[i], w[i], tol))
            row["scale"] = max(row["scale"], w[i].abs().max().item())
    return out


def stack_parity(arch: str) -> dict:
    """``arch``'s smoke config, layer stack, f32, served on the card and on
    the CPU from the same weights (seed 1): the same tokens and logits
    within 1e-3 of their scale.  The MLA config at ``MLA_SMOKE_QK``."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    if cfg.attn_type == "mla":
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, **MLA_SMOKE_QK))
    cpu_params = lm.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in (5, 9, 5, 12)]
    outs = {}
    for dev in ("cuda", "cpu"):
        params = _map(lambda t: t.to(dev), cpu_params)
        loop = ServeLoop(params, cfg, slots=2, max_len=32, record=True)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=5)
                for i, p in enumerate(prompts)]
        loop.drain(reqs)
        outs[dev] = (reqs, loop)
    (rg, lg), (rc, lc) = outs["cuda"], outs["cpu"]
    if [r.out for r in rg] != [r.out for r in rc]:
        raise AssertionError(f"{arch}: card and CPU tokens differ")
    err = max(float(np.abs(a - b).max()) for uid in lc.recorded_logits
              for a, b in zip(lg.recorded_logits[uid],
                              lc.recorded_logits[uid]))
    scale = max(float(np.abs(b).max()) for v in lc.recorded_logits.values()
                for b in v)
    if err > 1e-3 * max(scale, 1.0):
        raise AssertionError(f"{arch}: card vs CPU logits differ by "
                             f"{err:.3e} (scale {scale:.3e})")
    return dict(config=f"{arch} smoke f32 layer stack (d=64, "
                f"{cfg.num_layers} layers" + (
                    f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
                    if cfg.family == "moe" else "") + (
                    f", MLA qk {cfg.mla.qk_nope_dim} + {cfg.mla.qk_rope_dim}"
                    if cfg.attn_type == "mla" else "") + (
                    f", Mamba2 state {cfg.ssm.d_state} chunk {cfg.ssm.chunk}"
                    if cfg.family == "hybrid" else "") + ")",
                tokens_identical=True, max_abs_logit_err=err,
                logit_scale=scale)


def phase_moe(smi: str) -> dict:
    """The slice's main path: DeepSeek-V2-Lite at its published widths and
    full depth (27 layers, the first dense; MLA; 64 routed experts top-6 +
    2 shared), the layer stack, bf16, random weights (seed 0), served by
    ``ServeLoop`` (4 requests of 128/256 tokens over 4 slots, MOE_NEW new
    tokens, a MOE_MAX_LEN cache): sync with logits recorded, async with
    logits recorded (its tokens must be the sync drain's bit for bit, and
    its host waits only the one clock wait), then async unrecorded for
    the rate; the attention kernels (at head dim 192) and rmsnorm must
    launch; a profiled prefill tick and decode tick (``phase_profile``);
    the cache check against a full forward (``CACHE_SEEDS``; again at
    ``CACHE_CUT_LAYERS`` in bf16 and f32); then DeepSeekMoE-16B
    (GQA at hd 128) at published widths, V2-Lite as a DEQ (the
    ``DEQSettings`` defaults, 4 tied ``attn_moe`` blocks x0.3) and the
    card-vs-CPU parity of both MoE configs at smoke size.  (The kernels at
    the slice's new shapes are held and timed in phase 2.)  Returns the
    main drain's launch counts, the DEQ drain's and the per-call counts
    of the cache check."""
    out = {}
    cfg = get_config(MOE_ARCH)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    drains = {"sync": _moe_drain(params, cfg, "sync", record=True),
              "async": _moe_drain(params, cfg, "async", record=True)}
    if drains["async"]["tokens"] != drains["sync"]["tokens"]:
        raise AssertionError(f"{MOE_ARCH}: async tokens "
                             f"{drains['async']['tokens']} != sync "
                             f"{drains['sync']['tokens']}")
    # no read of the pipeline's own: the one wait pins the card's clock
    check_syncs(f"{MOE_ARCH} async drain", drains["async"]["syncs"], 1)
    drains["async_timed"] = _moe_drain(params, cfg, "async", record=False)
    for name, d in drains.items():
        missing = [k for k in ("flash_attention", "decode_attention",
                               "rmsnorm") if d["counts"][k] == 0]
        if missing:
            raise AssertionError(f"{MOE_ARCH} {name}: kernels not launched: "
                                 f"{missing}")
        say("moe_serve", config=f"{MOE_ARCH} layer stack (27 layers, d=2048, "
            "MLA 16 heads qk 128+64 v 128 rank 512, 64 experts top-6 + 2 "
            "shared, ff 1408, dense ff 10944, vocab 102400, bf16, seed 0)",
            pipeline=name, card=smi, params=n_params,
            init_seconds=round(t_init, 2), prompt_lens=MOE_PLENS,
            **{k: v for k, v in d.items() if k not in ("tokens", "syncs")},
            peak_mem_gib_over_base=(d["peak_mem_gib"]
                                    - base / 2 ** 30))
    phase_profile(params, cfg, smi)
    cache = check_cache_against_forward(params, cfg)
    say("moe_cache_check", config=f"{MOE_ARCH} 27 layers bf16", card=smi,
        **cache)
    out["drain"] = drains["async"]
    out["cache"] = cache
    del params
    torch.cuda.empty_cache()
    for dt, tol in (("bfloat16", CACHE_TOL), ("float32", (TOL_F32, TOL_F32))):
        cut = dataclasses.replace(cfg, num_layers=CACHE_CUT_LAYERS, dtype=dt)
        params = lm.init_params(cut, seed=0, device="cuda")
        say("moe_cache_check", config=f"{MOE_ARCH} {CACHE_CUT_LAYERS} layers "
            f"{dt}", card=smi,
            **check_cache_against_forward(params, cut, tol=tol))
        del params
        torch.cuda.empty_cache()

    cfg = get_config(MOE_GQA_ARCH)
    params = lm.init_params(cfg, seed=0, device="cuda")
    d = _moe_drain(params, cfg, "async", record=True)
    if d["counts"]["flash_attention"] == 0 or \
            d["counts"]["decode_attention"] == 0:
        raise AssertionError(f"{MOE_GQA_ARCH}: attention kernels not "
                             f"launched: {d['counts']}")
    say("moe_serve", config=f"{MOE_GQA_ARCH} layer stack (28 layers, "
        "d=2048, 16/16 heads x 128, 64 experts top-6 + 2 shared), bf16, "
        "seed 0; full depth", pipeline="async", card=smi,
        params=sum(t.numel() for t in _leaves(params)),
        **{k: v for k, v in d.items() if k not in ("tokens", "syncs")})
    del params
    torch.cuda.empty_cache()

    cfg = get_config(MOE_ARCH, deq=True)
    params = _scaled_blocks(lm.init_params(cfg, seed=0, device="cuda"), 0.3)
    d = _moe_drain(params, cfg, "async", record=True)
    missing = [k for k in SERVE_PATH if d["counts"][k] == 0]
    if missing:
        raise AssertionError(f"{MOE_ARCH} DEQ: kernels not launched: "
                             f"{missing}")
    say("moe_serve", config=f"{MOE_ARCH} DEQ (DEQSettings defaults: 4 tied "
        "attn_moe blocks x0.3, Broyden 12 steps, tol 1e-3, ring bf16 m=8)",
        pipeline="async", card=smi,
        params=sum(t.numel() for t in _leaves(params)),
        **{k: v for k, v in d.items() if k not in ("tokens", "syncs")})
    out["deq_counts"] = d["counts"]
    del params
    torch.cuda.empty_cache()

    for arch in (MOE_ARCH, MOE_GQA_ARCH):
        say("moe_parity", card=smi, **stack_parity(arch))
    return out


# ---------------------------------------------------------------------------
# phase 14: the hybrid family (Zamba2-2.7B), served and trained
# ---------------------------------------------------------------------------

HYBRID_ARCH = "zamba2-2.7b"
# 8 requests over 4 slots in prompt waves of 128, 256 and 300 tokens: a
# prompt of 128 is one SSD chunk of 128, 256 one full chunk, 300 pads to
# two (the second with dt = 0 steps); MOE_NEW new tokens, a MOE_MAX_LEN
# cache
HYBRID_PLENS = (128, 128, 256, 256, 300, 300, 128, 256)
HYBRID_CACHE_SEQS = (128, 300)
HYBRID_SCAN_SEQ = 300
# training: 4 AdamW steps of 4 x 512 synthetic tokens (two full chunks)
HYBRID_TRAIN = dict(steps=4, batch=4, seq=512)


def _hybrid_desc(cfg) -> str:
    s = cfg.ssm
    return (f"{cfg.name} ({cfg.num_layers} Mamba2 layers, d={cfg.d_model}, "
            f"state {s.d_state}, conv {s.d_conv}, expand {s.expand}, "
            f"SSM heads {s.expand * cfg.d_model // s.head_dim} x "
            f"{s.head_dim}, chunk {s.chunk}; a shared attention + MLP "
            f"block ({cfg.num_heads}/{cfg.num_kv_heads} heads x "
            f"{cfg.head_dim}, ff {cfg.d_ff}) every {s.attn_every} layers; "
            f"vocab {cfg.vocab_size}; {cfg.dtype}, random weights, seed 0)")


def _forward_launches(cfg) -> dict:
    """Launches of one full-sequence forward of the layer stack (no DEQ):
    rmsnorm twice per block (twice per Mamba layer: its ln and its gated
    norm; MLA's kv_norm once more; once per xLSTM layer) plus the final
    norm, flash attention once per attention block (none in xLSTM);
    ``inside`` the same without the final norm (what a rematerialised unit
    launches again in the backward); the flash_xla and plain attention
    routes (``cfg.attn_impl``) launch no attention kernel."""
    if cfg.family == "hybrid":
        units = cfg.num_layers // cfg.ssm.attn_every
        norms = 2 * cfg.num_layers + 2 * units
        attn = units
    elif cfg.family == "ssm":   # a pre-norm per mLSTM / sLSTM layer
        norms, attn = cfg.num_layers, 0
    else:
        attn = cfg.num_layers
        norms = (3 if cfg.attn_type == "mla" else 2) * cfg.num_layers
    if cfg.attn_impl in ("flash_xla", "ref"):
        attn = 0
    return {"rmsnorm": norms + 1, "flash_attention": attn,
            "inside": {"rmsnorm": norms, "flash_attention": attn}}


def _batches(cfg, batch: int, seq: int):
    """Seed-0 training batches of ``seq`` positions: the synthetic token
    stream, or for the audio and vlm families the stub frontends' random
    batches (``stub_batch``, seed = the step)."""
    if cfg.family in ("audio", "vlm"):
        return (stub_batch(cfg, batch, seq, seed=i, device="cuda")
                for i in itertools.count())
    return make_lm_batch_iterator(cfg, batch, seq, seed=0, device="cuda")


def stack_train(params, cfg, remat: str, *, steps: int, batch: int,
                seq: int, desc: str, smi: str) -> dict:
    """``steps`` AdamW steps of the layer stack (``build_train_step``,
    ``cfg.remat = remat``) from ``params`` (left as they are) on
    ``_batches``' seed-0 batches, each step timed to the card's last
    kernel; the launch counts reset before the first step and read after
    the last (per step they must be one forward's, plus one recompute of
    every unit under ``full``: ``_forward_launches``; a DEQ model's are
    reported, and its solve steps and statuses); the peak device memory.
    Every loss and grad norm finite, no step skipped."""
    cfg = dataclasses.replace(cfg, remat=remat)
    tcfg = TrainConfig(steps=steps, global_batch=batch, seq_len=seq,
                       schedule=cfg.schedule)
    state = train_steps.init_train_state(cfg, tcfg, params=params)
    step = train_steps.build_train_step(cfg, tcfg)
    batches = _batches(cfg, batch, seq)
    solves = []
    rows = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    for i in range(steps):
        b = next(batches)
        t0 = time.perf_counter()
        with _record_forward(solves):
            state, m = step(state, b)
        torch.cuda.synchronize()
        rows.append(dict(step=i + 1, loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         skipped=float(m["update_skipped"]),
                         step_ms=(time.perf_counter() - t0) * 1e3))
    counts = launches.counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in rows:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                and r["skipped"] == 0.0):
            raise AssertionError(f"{desc} remat={remat} step {r['step']}: "
                                 f"{r}")
    if not cfg.deq.enabled:
        fwd = _forward_launches(cfg)
        want = {k: steps * (fwd[k] + (fwd["inside"][k] if remat == "full"
                                      else 0))
                for k in ("rmsnorm", "flash_attention")}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"{desc} remat={remat}: launches {got}, "
                                 f"want {want}")
    say("train_stack", config=desc, remat=remat, card=smi,
        attn_impl=cfg.attn_impl, batch=f"{batch} x {seq}", steps=rows,
        solves=[(int(n), st.tolist()) for n, st in solves],
        peak_mem_gib=peak,
        launches=counts, launches_per_step={k: n / steps
                                            for k, n in counts.items() if n})
    del state
    torch.cuda.empty_cache()
    return dict(rows=rows, counts=counts, peak_mem_gib=peak,
                solves=[(int(n), st.tolist()) for n, st in solves])


def check_scan_ref(params, cfg, seq: int, smi: str) -> None:
    """One Mamba2 layer of ``params`` (unit 0, layer 0) at its published
    shapes, chunked SSD against the sequential ``mamba2_scan_ref`` on the
    card over B=4 x ``seq`` (``seq`` 300 pads the last chunk): in f32 at
    TOL_F32, and in bf16 reported (the two round the projections'
    outputs in other orders)."""
    layer = {k: v[0, 0] for k, v in params["group0"]["mamba"]["m"].items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(4, seq, cfg.d_model, device="cuda", generator=gen)
    row = {}
    for dt in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=str(dt)[6:])
        p = {k: v.to(dt) for k, v in layer.items()}
        with torch.no_grad():
            got, _ = ssm_mod.mamba2_block(p, x.to(dt), c)
            want = ssm_mod.mamba2_scan_ref(p, x.to(dt), c)
        tol = TOL_F32 if dt == torch.float32 else TOL_BF16
        tag = f"mamba2_block chunked vs scan_ref {str(dt)[6:]} B=4 S={seq}"
        row[str(dt)[6:]] = dict(
            max_abs_err=(check_close(tag, got, want, tol)
                         if dt == torch.float32 else
                         (got.float() - want.float()).abs().max().item()),
            limit_share=limit_share(got, want, tol), tol=tol,
            scale=want.float().abs().max().item())
    say("hybrid_scan_ref", config=f"{cfg.name} one layer (d={cfg.d_model}, "
        f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSM heads, "
        f"chunk {cfg.ssm.chunk})", card=smi, checked="float32",
        reported="bfloat16", **row)


def shared_grad_norm(params, cfg, seq: int) -> float:
    """The norm of the loss's gradient in the shared block's weights over
    one seed-0 batch of 4 x ``seq`` (the train step's loss, remat on)."""
    shared = _map(lambda t: t.detach().requires_grad_(True),
                  params["shared_attn"])
    b = next(make_lm_batch_iterator(cfg, 4, seq, seed=0, device="cuda"))
    loss, _ = lm.loss_fn(dict(params, shared_attn=shared), b, cfg)
    grads = torch.autograd.grad(loss, _leaves(shared))
    return float(torch.sqrt(sum(g.float().square().sum() for g in grads)))


def stack_train_parity(arch: str, deq: bool = False) -> dict:
    """``arch``'s smoke config in f32 (the layer stack, or with ``deq`` its
    DEQ form: tied blocks x0.3, an f32 ring), 3 AdamW steps on the card and
    on the CPU from the same weights (seed 1) and batches of 2 x 20 (the
    synthetic token stream; for the audio and vlm families ``stub_batch``,
    the vlm's 8 image tokens among the 20 positions): the same forward
    solver steps, loss at rtol 1e-4, grad norm at rtol 2e-3 (as
    ``phase_train_parity``)."""
    cfg = dataclasses.replace(smoke_config(arch, deq=deq), dtype="float32")
    tcfg = TrainConfig(steps=3, global_batch=2, seq_len=20, lr=1e-3,
                       warmup_steps=2)
    cpu_params = lm.init_params(cfg, seed=1, device="cpu")
    if deq:
        cfg = dataclasses.replace(cfg, deq=dataclasses.replace(
            cfg.deq, qn_dtype="float32"))
        cpu_params = _scaled_blocks(cpu_params, 0.3)
    ds = SyntheticTokenDataset(cfg.vocab_size, 0)

    def batch(i, dev):
        if cfg.family in ("audio", "vlm"):
            return stub_batch(cfg, 2, 20, seed=i, device=dev)
        toks = torch.from_numpy(ds.batch(i, 2, 21)).to(dev)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    seen = {}
    for dev in ("cuda", "cpu"):
        state = train_steps.init_train_state(
            cfg, tcfg, params=_map(lambda t: t.to(dev), cpu_params))
        step = train_steps.build_train_step(cfg, tcfg)
        seen[dev] = []
        for i in range(3):
            state, m = step(state, batch(i, dev))
            seen[dev].append((m.get("deq_steps", 0.0), float(m["loss"]),
                              float(m["grad_norm"])))
    for i, ((sg, lg, gg), (sc, lc, gc)) in enumerate(zip(seen["cuda"],
                                                         seen["cpu"])):
        if sg != sc or abs(lg - lc) > 1e-4 * abs(lc) \
                or abs(gg - gc) > 2e-3 * abs(gc):
            raise AssertionError(f"{arch} (deq={deq}) train step {i}: card "
                                 f"{seen['cuda'][i]} vs CPU {seen['cpu'][i]}")
    return dict(config=f"{arch} smoke f32 " + (
        "DEQ (2 blocks x0.3, ring f32)" if deq else
        f"layer stack, remat {cfg.remat}") + ", batch 2 x 20, 3 AdamW steps",
        steps_card=seen["cuda"], steps_cpu=seen["cpu"],
        tol="same solver steps; loss rtol 1e-4; grad norm rtol 2e-3")


def phase_hybrid(smi: str) -> dict:
    """The hybrid family's main path: Zamba2-2.7B at its published widths
    and full depth (54 Mamba2 layers, 9 calls of the shared block), bf16,
    random weights (seed 0), the layer stack:

      * ``ServeLoop`` over 4 slots, HYBRID_PLENS prompts, MOE_NEW new
        tokens, a MOE_MAX_LEN cache: sync, then async (its tokens the sync
        drain's bit for bit, its one host wait the clock wait); rmsnorm and
        both attention kernels must launch;
      * a profiled prefill tick and decode tick (``phase_profile``);
      * prefill over S then one decode step against a forward over S + 1
        for S in HYBRID_CACHE_SEQS at every seed of CACHE_SEEDS: in f32 at
        full depth, held at TOL_F32; in bf16 reported against CACHE_TOL
        beside the forward's own rounding floor (two bf16 forwards of the
        same rows at batch 1 and 2 already differ by more than CACHE_TOL
        at this depth, so bf16 cannot be held to it);
      * one layer's chunked SSD against ``mamba2_scan_ref`` at S = 300;
      * 4 AdamW steps at 4 x 512 with ``remat="full"`` (``stack_train``),
        then the shared block's gradient norm, which must be non-zero;
      * an async drain of the DEQ form (4 tied ``zamba_unit``s, tied
        weights x0.3: ``_scaled_blocks``) with its solve steps and
        statuses;
      * card against CPU at the smoke size in f32: a drain and 3 train
        steps.

    Returns the async drain's, a train step's and the DEQ drain's launch
    counts."""
    out = {}
    cfg = get_config(HYBRID_ARCH)
    desc = _hybrid_desc(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    drains = {p: _moe_drain(params, cfg, p, record=True, plens=HYBRID_PLENS)
              for p in ("sync", "async")}
    if drains["async"]["tokens"] != drains["sync"]["tokens"]:
        raise AssertionError(f"{HYBRID_ARCH}: async tokens "
                             f"{drains['async']['tokens']} != sync "
                             f"{drains['sync']['tokens']}")
    check_syncs(f"{HYBRID_ARCH} async drain", drains["async"]["syncs"], 1)
    for name, d in drains.items():
        missing = [k for k in ("flash_attention", "decode_attention",
                               "rmsnorm") if d["counts"][k] == 0]
        if missing:
            raise AssertionError(f"{HYBRID_ARCH} {name}: kernels not "
                                 f"launched: {missing}")
        say("hybrid_serve", config=desc, pipeline=name, card=smi,
            params=n_params, init_seconds=t_init, prompt_lens=HYBRID_PLENS,
            **{k: v for k, v in d.items() if k not in ("tokens", "syncs")})
    out["drain"] = drains["async"]
    phase_profile(params, cfg, smi)
    out["cache"] = {}
    for seq in HYBRID_CACHE_SEQS:
        cache = check_cache_against_forward(params, cfg, seq=seq, hold=False)
        say("hybrid_cache_check", config=f"{HYBRID_ARCH} "
            f"{cfg.num_layers} layers bf16 (reported)", card=smi, **cache)
        out["cache"][seq] = cache
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _map(lambda t: t.float(), params)
    for seq in HYBRID_CACHE_SEQS:
        say("hybrid_cache_check", config=f"{HYBRID_ARCH} "
            f"{cfg.num_layers} layers float32 (held)", card=smi,
            **check_cache_against_forward(p32, cfg32, seq=seq,
                                          tol=(TOL_F32, TOL_F32)))
    del p32
    torch.cuda.empty_cache()
    check_scan_ref(params, cfg, HYBRID_SCAN_SEQ, smi)
    torch.cuda.empty_cache()

    tr = stack_train(params, cfg, "full", steps=HYBRID_TRAIN["steps"],
                     batch=HYBRID_TRAIN["batch"], seq=HYBRID_TRAIN["seq"],
                     desc=desc, smi=smi)
    gnorm = shared_grad_norm(params, cfg, HYBRID_TRAIN["seq"])
    if not (np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"{HYBRID_ARCH}: shared_attn gradient norm "
                             f"{gnorm}")
    say("hybrid_shared_grad", card=smi, shared_attn_grad_norm=gnorm,
        batch=f"4 x {HYBRID_TRAIN['seq']}")
    out["train"] = tr["counts"]
    del params
    torch.cuda.empty_cache()

    cfg = get_config(HYBRID_ARCH, deq=True)
    params = _scaled_blocks(lm.init_params(cfg, seed=0, device="cuda"), 0.3)
    d = _moe_drain(params, cfg, "async", record=True, plens=HYBRID_PLENS)
    missing = [k for k in SERVE_PATH if d["counts"][k] == 0]
    if missing:
        raise AssertionError(f"{HYBRID_ARCH} DEQ: kernels not launched: "
                             f"{missing}")
    say("hybrid_serve", config=f"{HYBRID_ARCH} DEQ (DEQSettings defaults: "
        "4 tied zamba_units of 6 Mamba2 layers + the shared block, tied "
        "weights x0.3, Broyden 12 steps, tol 1e-3, ring bf16 m=8)", pipeline="async", card=smi,
        params=sum(t.numel() for t in _leaves(params)),
        **{k: v for k, v in d.items() if k not in ("tokens", "syncs")})
    out["deq_counts"] = d["counts"]
    del params
    torch.cuda.empty_cache()

    say("hybrid_parity", card=smi, **stack_parity(HYBRID_ARCH))
    say("hybrid_train_parity", card=smi, **stack_train_parity(HYBRID_ARCH))
    return out


# ---------------------------------------------------------------------------
# phase 15: the SSM family (xLSTM-1.3B), served, trained and as a DEQ
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-1.3b"
# the hybrid phase's waves: a prompt of 128 is one mLSTM chunk of 128, 256
# one full chunk, 300 pads to two (the second with state-neutral gates)
XLSTM_PLENS = HYBRID_PLENS
XLSTM_CACHE_SEQS = (128, 300)
# the bf16 cache check is reported, not held: at the padded length only
XLSTM_CACHE_SEQ_BF16 = 300
XLSTM_SCAN_SEQ = 300
XLSTM_TRAIN = dict(steps=4, batch=4, seq=512)
# that step's peak before the chunk and time loops kept only their entry
# states (NVIDIA H100 80GB HBM3, 700 W): it is set by the stacked leaves'
# gradients and their f32 copies, which the loops do not change
XLSTM_STACKED_GRADS_PEAK_GIB = 32.06
# the DEQ form reruns its four tied units' sLSTM time loops at every solver
# evaluation, so its prompts are short
XLSTM_DEQ_PLENS = (64, 128, 64, 128)
# the chunked cells against their sequential oracles, in f32
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
# the traced train step: at 4 x 128 the trace held 93 k kernels and took
# ~65 s to take and read, at 4 x 64 (PRs 21-25) 49 s; at 4 x 32 about half
# that, so the script stays inside its time with the examples' phase
XLSTM_PROFILE_SEQ = 32


def _xlstm_desc(cfg) -> str:
    x = cfg.xlstm
    inner = int(cfg.d_model * x.mlstm_proj_factor)
    n_s = cfg.num_layers // x.slstm_every
    return (f"{cfg.name} ({cfg.num_layers - n_s} mLSTM + {n_s} sLSTM "
            f"layers, d={cfg.d_model}, {cfg.num_heads} heads; mLSTM inner "
            f"{inner} (heads of {inner // cfg.num_heads}), chunk {x.chunk}; "
            f"sLSTM heads of {cfg.d_model // cfg.num_heads}, ff "
            f"{xlstm_mod._slstm_ff(cfg)}; vocab {cfg.vocab_size}; "
            f"{cfg.dtype}, random weights, seed 0)")


def _scaled_tol(want: torch.Tensor) -> dict:
    """SCAN_TOL with its atol scaled to ``want``'s largest entry."""
    return dict(rtol=SCAN_TOL["rtol"],
                atol=SCAN_TOL["atol"] * max(want.abs().max().item(), 1e-30))


def check_xlstm_cells(params, cfg, seq: int, smi: str) -> None:
    """The xLSTM cells at their published shapes against their sequential
    oracles on the card, in f32 over B=4 x ``seq`` (``seq`` 300 pads the
    mLSTM's last chunk), at SCAN_TOL with the atol scaled to each output's
    largest entry: the chunked mLSTM cell against ``mlstm_step`` run
    position by position over unit-scale inputs at its shapes (4 heads of
    1024; at this init a layer's own projections give outputs near 1e-7,
    which an unscaled atol could not see), its output and final ``(C, n,
    m)``; and unit 0's sLSTM block, whose input projection is hoisted over
    the sequence, against ``slstm_scan_ref``, which projects each step's
    input and writes the recurrence out apart from ``_slstm_recur``.  q
    and k are drawn around 1, so that the normaliser ``|q . n|`` stays off
    0: around 0 the output ``num / den`` magnifies f32 rounding wherever
    the two sums nearly cancel (at mean 0 the card read 0.73 of the
    limit).  Then both loops' ``autograd.Function``s (``_MLSTMChunks``,
    ``_SLSTMSteps``) against their plain loops on the same inputs, their
    outputs and every input's gradient for the same unit-scale
    cotangents, at the same tolerance (``xlstm_function_grads``)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    _, h, hd = xlstm_mod._mlstm_dims(cfg)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, k = (1 + randn(4, seq, h, hd) for _ in range(2))
    v = randn(4, seq, h, hd)
    i_pre, f_pre = 2 * randn(4, seq, h), 2 + 2 * randn(4, seq, h)
    cache = cache0 = xlstm_mod.mlstm_cache_shape(cfg, 4, "cuda")
    s_params = {k_: v_[0].float()
                for k_, v_ in params["group0"]["slstm"]["s"].items()}
    x = randn(4, seq, cfg.d_model)
    with torch.no_grad():
        y, state = xlstm_mod.mlstm_cell_chunked(q, k, v, i_pre, f_pre, cache,
                                                cfg.xlstm.chunk)
        ys = []
        for t in range(seq):
            yt, cache = xlstm_mod.mlstm_step(q[:, t], k[:, t], v[:, t],
                                             i_pre[:, t], f_pre[:, t], cache)
            ys.append(yt)
        pairs = {"mlstm_y": (y, torch.stack(ys, dim=1))}
        pairs.update({f"mlstm_{f}": (getattr(state, f), getattr(cache, f))
                      for f in xlstm_mod.MLSTMCache._fields})
        pairs["slstm_out"] = (xlstm_mod.slstm_block(s_params, x, cfg)[0],
                              xlstm_mod.slstm_scan_ref(s_params, x, cfg))
    row = {}
    for name, (got, want) in pairs.items():
        tol = _scaled_tol(want)
        row[name] = dict(
            max_abs_err=check_close(f"{name} vs sequential f32 B=4 S={seq}",
                                    got, want, tol),
            limit_share=limit_share(got, want, tol),
            scale=want.abs().max().item())
    say("xlstm_scan_ref", config=f"{cfg.name} (mLSTM {h} heads of {hd}, "
        f"chunk {cfg.xlstm.chunk}; unit 0's sLSTM, d={cfg.d_model})",
        card=smi, tol=SCAN_TOL, atol="times each output's largest entry",
        **row)

    # the loops' autograd Functions (entry states saved, each chunk or step
    # recomputed in the backward) against the plain loops, whose autograd
    # keeps every intermediate: outputs and every input's gradient for the
    # same unit-scale cotangents
    def grads(fn, args, n_in):
        args = [t.detach().clone().requires_grad_(True) for t in args]
        outs = fn(*args)
        outs = (outs[0], *outs[1])
        cots = [randn(*t.shape) for t in outs]
        return list(outs) + list(torch.autograd.grad(outs, args[:n_in],
                                                     cots))

    def mlstm(ref):
        fn = (xlstm_mod.mlstm_cell_chunked_ref if ref
              else xlstm_mod.mlstm_cell_chunked)
        return lambda *a: fn(*a[:5], xlstm_mod.MLSTMCache(*a[5:]),
                             cfg.xlstm.chunk)

    def slstm(ref):
        fn = xlstm_mod.slstm_steps_ref if ref else xlstm_mod.slstm_steps
        return lambda *a: fn(a[0], a[1], xlstm_mod.SLSTMCache(*a[2:]), cfg)

    m_args = (q, k, v, i_pre, f_pre, *cache0)
    with torch.no_grad():
        pre = xlstm_mod._slstm_input(s_params, x)
    s_args = (s_params["r"], pre, *xlstm_mod.slstm_cache_shape(cfg, 4,
                                                               "cuda"))
    row = {}
    for tag, make, args, names in (
            ("mlstm", mlstm, m_args, ("y", "C", "n", "m", "dq", "dk", "dv",
                                      "di", "df", "dC", "dn", "dm")),
            ("slstm", slstm, s_args, ("h", "c", "n", "h_last", "m", "dr",
                                      "dpre", "dc", "dn", "dh", "dm"))):
        gen.manual_seed(11)
        got = grads(make(False), args, len(args))
        gen.manual_seed(11)
        want = grads(make(True), args, len(args))
        for name, g, w in zip(names, got, want):
            tol = _scaled_tol(w)
            row[f"{tag}_{name}"] = check_close(
                f"{tag} Function {name} vs plain loop f32 B=4 S={seq}", g, w,
                tol)
    say("xlstm_function_grads", config=f"{cfg.name} (mLSTM {h} heads of "
        f"{hd}, chunk {cfg.xlstm.chunk}; unit 0's sLSTM recurrence)",
        card=smi, tol=SCAN_TOL, atol="times each output's largest entry",
        max_abs_err=row)


def profile_train_step(params, cfg, *, batch: int, seq: int,
                       smi: str) -> None:
    """One train step of the layer stack (``build_train_step``, the
    config's remat) traced after a warm-up step: device busy time, idle
    share and launches, at a short ``seq`` (the trace holds every host op
    and kernel)."""
    tcfg = TrainConfig(steps=2, global_batch=batch, seq_len=seq,
                       schedule=cfg.schedule)
    state = train_steps.init_train_state(cfg, tcfg, params=params)
    step = train_steps.build_train_step(cfg, tcfg)
    batches = _batches(cfg, batch, seq)
    state, _ = step(state, next(batches))
    b = next(batches)
    prof = _profile_window(lambda: step(state, b))
    say("profile", window=f"train_step {batch} x {seq}", config=cfg.name,
        remat=cfg.remat, card=smi, **prof)
    del state
    torch.cuda.empty_cache()


def phase_xlstm(smi: str) -> dict:
    """The SSM family's main path: xLSTM-1.3B at its published widths and
    full depth (42 mLSTM and 6 sLSTM layers), bf16, random weights (seed
    0), the layer stack; no attention, so neither attention kernel may
    launch:

      * ``ServeLoop`` over 4 slots, XLSTM_PLENS prompts, MOE_NEW new
        tokens, a MOE_MAX_LEN cache: sync, then async (its tokens the sync
        drain's bit for bit, its one host wait the clock wait); rmsnorm
        must launch in both;
      * a profiled prefill tick and decode tick (``phase_profile``);
      * prefill over S then one decode step against a forward over S + 1
        for S in XLSTM_CACHE_SEQS at every seed of CACHE_SEEDS, in f32
        held at TOL_F32; at this init an mLSTM layer adds ~1e-7 to the
        residual stream, so the logits see the sLSTM layers and the stack,
        and each layer's cache leaves (C, n, m; c, n, h, m) are held
        against a prefill over S + 1 at ``_scaled_tol`` of their own scale
        (``check_cache_leaves``); in bf16 at XLSTM_CACHE_SEQ_BF16,
        reported against CACHE_TOL beside the forward's own rounding
        floor;
      * unit 0's mLSTM and sLSTM blocks against their sequential oracles
        (``check_xlstm_cells``);
      * 4 AdamW steps at 4 x 512 with ``remat="full"`` (``stack_train``),
        after which the caller's weights must be bit for bit as before
        (the step updates its own copy in place); one more step at 4 x
        XLSTM_PROFILE_SEQ traced (``profile_train_step``);
      * an async drain of the DEQ form (4 tied ``xlstm_unit``s, tied
        weights x0.3) over XLSTM_DEQ_PLENS: both qN kernels and rmsnorm
        launch, the attention kernels not; solve steps and statuses;
      * card against CPU at the smoke size in f32: a drain and 3 train
        steps.

    Returns the async drain's, the train steps' and the DEQ drain's launch
    counts, and the f32 cache check's per-call counts; an
    ``xlstm_phase_split`` line gives each part's seconds, to the card's
    last kernel."""
    out, split = {}, {}
    t_mark = [time.perf_counter()]

    def lap(part: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[part] = now - t_mark[0]
        t_mark[0] = now

    cfg = get_config(XLSTM_ARCH)
    desc = _xlstm_desc(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    drains = {p: _moe_drain(params, cfg, p, record=True, plens=XLSTM_PLENS)
              for p in ("sync", "async")}
    if drains["async"]["tokens"] != drains["sync"]["tokens"]:
        raise AssertionError(f"{XLSTM_ARCH}: async tokens "
                             f"{drains['async']['tokens']} != sync "
                             f"{drains['sync']['tokens']}")
    check_syncs(f"{XLSTM_ARCH} async drain", drains["async"]["syncs"], 1)
    for name, d in drains.items():
        attn = {k: d["counts"][k] for k in ("flash_attention",
                                             "decode_attention")}
        if d["counts"]["rmsnorm"] == 0 or any(attn.values()):
            raise AssertionError(f"{XLSTM_ARCH} {name}: launches "
                                 f"{d['counts']}")
        say("xlstm_serve", config=desc, pipeline=name, card=smi,
            params=n_params, init_seconds=t_init, prompt_lens=XLSTM_PLENS,
            **{k: v for k, v in d.items() if k not in ("tokens", "syncs")})
    out["drain"] = drains["async"]
    lap("drains")
    phase_profile(params, cfg, smi)
    lap("profile")
    say("xlstm_cache_check", config=f"{XLSTM_ARCH} {cfg.num_layers} "
        "layers bf16 (reported)", card=smi, **check_cache_against_forward(
            params, cfg, seq=XLSTM_CACHE_SEQ_BF16, hold=False))
    lap("cache_bf16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _map(lambda t: t.float(), params)
    out["cache"] = {}
    for seq in XLSTM_CACHE_SEQS:
        cache = check_cache_against_forward(p32, cfg32, seq=seq,
                                            tol=(TOL_F32, TOL_F32),
                                            leaves=True)
        say("xlstm_cache_check", config=f"{XLSTM_ARCH} {cfg.num_layers} "
            "layers float32 (held; cache leaves at _scaled_tol)", card=smi,
            **cache)
        out["cache"][seq] = cache
    del p32
    torch.cuda.empty_cache()
    lap("cache_f32")
    check_xlstm_cells(params, cfg, XLSTM_SCAN_SEQ, smi)
    torch.cuda.empty_cache()
    lap("cells")

    before = _map(lambda t: t.cpu(), params)
    tr = stack_train(params, cfg, "full", steps=XLSTM_TRAIN["steps"],
                     batch=XLSTM_TRAIN["batch"], seq=XLSTM_TRAIN["seq"],
                     desc=desc, smi=smi)
    changed = [k for k, (a, b) in enumerate(zip(_leaves(before),
                                                 _leaves(params)))
               if not torch.equal(a, b.cpu())]
    if changed:
        raise AssertionError(f"{XLSTM_ARCH}: training changed the caller's "
                             f"weights (leaves {changed})")
    del before
    say("xlstm_train_peak", config=desc, card=smi,
        batch=f"{XLSTM_TRAIN['batch']} x {XLSTM_TRAIN['seq']}",
        peak_mem_gib=tr["peak_mem_gib"],
        earlier_peak_gib=XLSTM_STACKED_GRADS_PEAK_GIB)
    out["train"] = tr["counts"]
    lap("train")
    profile_train_step(params, dataclasses.replace(cfg, remat="full"),
                       batch=XLSTM_TRAIN["batch"], seq=XLSTM_PROFILE_SEQ,
                       smi=smi)
    del params
    torch.cuda.empty_cache()
    lap("train_profile")

    cfg = get_config(XLSTM_ARCH, deq=True)
    params = _scaled_blocks(lm.init_params(cfg, seed=0, device="cuda"), 0.3)
    d = _moe_drain(params, cfg, "async", record=True, plens=XLSTM_DEQ_PLENS)
    want = ("broyden_step", "qn_apply_multi", "rmsnorm")
    if any(d["counts"][k] == 0 for k in want) or \
            d["counts"]["flash_attention"] or d["counts"]["decode_attention"]:
        raise AssertionError(f"{XLSTM_ARCH} DEQ: launches {d['counts']}")
    say("xlstm_serve", config=f"{XLSTM_ARCH} DEQ (DEQSettings defaults: 4 "
        "tied xlstm_units of 7 mLSTM + 1 sLSTM layers, tied weights x0.3, "
        "Broyden 12 steps, tol 1e-3, ring bf16 m=8)", pipeline="async",
        card=smi, params=sum(t.numel() for t in _leaves(params)),
        prompt_lens=XLSTM_DEQ_PLENS,
        **{k: v for k, v in d.items() if k not in ("tokens", "syncs")})
    out["deq_counts"] = d["counts"]
    del params
    torch.cuda.empty_cache()
    lap("deq")

    say("xlstm_parity", card=smi, **stack_parity(XLSTM_ARCH))
    say("xlstm_train_parity", card=smi, **stack_train_parity(XLSTM_ARCH))
    lap("parity")
    say("xlstm_phase_split", card=smi, seconds=split)
    return out


# ---------------------------------------------------------------------------
# phase 16: training the layer stack with and without rematerialisation
# ---------------------------------------------------------------------------

# full width, depth cut to 4 layers (the dense layer and 3 MoE layers;
# 2.25 B parameters): params and grads in bf16 and AdamW's f32 moments
# come to ~27 GB, and the step's peak (the state updated in place, the
# caller's weights, the clipped gradients' copy) to ~37 GiB
TRAIN_STACK_LAYERS = 4
TRAIN_STACK = dict(steps=3, batch=4, seq=256)


def phase_train_stack(smi: str) -> dict:
    """DeepSeek-V2-Lite (MLA + MoE) and DeepSeekMoE-16B (GQA + MoE) at
    their published widths, depth cut to TRAIN_STACK_LAYERS, bf16, seed 0:
    TRAIN_STACK's AdamW steps with ``remat="full"``, then the same steps
    from the same weights with ``remat="none"``, held at
    ``hold_trajectory``'s tolerances (loss rtol 1e-2, grad norm rtol 5e-2
    at every step: the MoE's gather accumulates with atomics on the card,
    so the recompute is not bit for bit the forward); peak memory of both.
    Returns V2-Lite's remat-full launch counts."""
    out = {}
    for arch in (MOE_ARCH, MOE_GQA_ARCH):
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=TRAIN_STACK_LAYERS)
        params = lm.init_params(cfg, seed=0, device="cuda")
        desc = (f"{arch} layer stack at full width, {TRAIN_STACK_LAYERS} "
                f"layers (1 dense + {TRAIN_STACK_LAYERS - 1} MoE), bf16, "
                f"seed 0, {sum(t.numel() for t in _leaves(params))} params")
        arms = {r: stack_train(params, cfg, r, desc=desc, smi=smi,
                               **TRAIN_STACK) for r in ("full", "none")}
        rows = {r: [(0, x["loss"], x["grad_norm"], 0) for x in a["rows"]]
                for r, a in arms.items()}
        # no solves in the layer stack: the none arm stands for both of
        # hold_trajectory's reference arms
        rel = hold_trajectory(rows["full"], rows["none"], rows["none"])
        say("train_stack_remat", config=desc, card=smi,
            rel_diff=rel["replay"], tol="loss rtol 1e-2, grad norm rtol "
            "5e-2 at every step (hold_trajectory)",
            peak_mem_gib={r: a["peak_mem_gib"] for r, a in arms.items()},
            step_ms={r: [x["step_ms"] for x in a["rows"]]
                     for r, a in arms.items()})
        out.setdefault("counts", arms["full"]["counts"])
        del params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 17: the audio and VLM families (HuBERT-XLarge, Pixtral-12B)
# ---------------------------------------------------------------------------

AUDIO_ARCH = "hubert-xlarge"
VLM_ARCH = "pixtral-12b"
# HuBERT-XLarge: 3 AdamW steps of the layer stack at 4 x 1000 stub frames
# (20 s of audio at 50 frames a second), remat full; 2 steps of the DEQ form
AUDIO_TRAIN = dict(steps=3, batch=4, seq=1000)
AUDIO_DEQ_TRAIN = dict(steps=2, batch=4, seq=1000)
# Pixtral-12B serves text only (the reference's ServeLoop): 8 requests over
# 4 slots, prompts of 128 and 256 tokens, MOE_NEW new tokens, a 2048-token
# cache; the cache check with images: prefill over the 1024 image
# embeddings + VLM_CACHE_TEXT tokens and one decode step, at each seed of
# VLM_CACHE_SEEDS
VLM_PLENS = (128, 256, 128, 256, 128, 256, 128, 256)
VLM_MAX_LEN = 2048
VLM_CACHE_TEXT = 128
VLM_CACHE_SEEDS = (1, 2)
# training at full width, depth cut to 6 layers (1.34 B of embedding and
# head + 6 x 0.27 B; 40 layers would need ~196 GB of state at 16 B a
# parameter): 2 AdamW steps of 2 x (1024 image + 512 text) tokens, with
# the kernel (attn_impl "auto") and again with the chunked flash_xla path
VLM_TRAIN_LAYERS = 6
VLM_TRAIN = dict(steps=2, batch=2, seq=1024 + 512)


def _frontend_desc(cfg) -> str:
    audio = cfg.family == "audio"
    return (f"{cfg.name} ({cfg.num_layers} layers, d={cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, "
            f"ff {cfg.d_ff} {'GELU' if cfg.act == 'gelu' else 'SwiGLU'}, "
            f"{'causal' if cfg.causal else 'not causal'}, "
            f"{cfg.padded_vocab} {'classes' if audio else 'vocab'}"
            + ("" if audio else f", {cfg.num_image_tokens} image tokens")
            + f"; {cfg.dtype}, random weights, seed 0)")


def check_image_cache(params, cfg, tol, *, hold: bool) -> dict:
    """Prefill over ``cfg.num_image_tokens`` image embeddings +
    VLM_CACHE_TEXT tokens, then one decode step, against a forward over
    the images + VLM_CACHE_TEXT + 1 tokens (``stub_batch``, B=2, each seed
    of VLM_CACHE_SEEDS): the last prefill logits at ``tol[0]``, the decode
    step's at ``tol[1]``; the prefill's lengths must count the image
    tokens.  ``hold=False`` reports the readings beside the forward's own
    rounding floor (each row forwarded alone against the batch)."""
    n, text = cfg.num_image_tokens, VLM_CACHE_TEXT
    seeds, counts = {}, {}
    for seed in VLM_CACHE_SEEDS:
        b = stub_batch(cfg, 2, n + text + 1, seed=seed, device="cuda")
        img, toks = b["image_embeds"], b["tokens"]
        with torch.no_grad():
            full, _ = lm.forward(params, {"tokens": toks,
                                          "image_embeds": img}, cfg,
                                 train=False)
        launches.reset()
        pre, caches, lens = lm.prefill(
            params, {"tokens": toks[:, :text], "image_embeds": img}, cfg,
            VLM_MAX_LEN)
        counts.setdefault("prefill", launches.counts())
        if lens.tolist() != [n + text] * 2:
            raise AssertionError(f"{cfg.name}: prefill lengths "
                                 f"{lens.tolist()}, want {n + text}")
        launches.reset()
        dec, _ = lm.decode_step(params, caches, toks[:, text], lens, cfg)
        counts.setdefault("decode", launches.counts())
        del caches
        pairs = [("prefill", pre[:, -1], full[:, n + text - 1], tol[0]),
                 ("decode", dec, full[:, n + text], tol[1])]
        if not hold:
            with torch.no_grad():
                alone = torch.cat([lm.forward(
                    params, {"tokens": toks[i:i + 1],
                             "image_embeds": img[i:i + 1]}, cfg,
                    train=False)[0][:, n + text - 1:] for i in range(2)])
            pairs += [("noise_prefill", alone[:, 0], full[:, n + text - 1],
                       tol[0]),
                      ("noise_decode", alone[:, 1], full[:, n + text],
                       tol[1])]
        row = seeds[seed] = {}
        for tag, got, want, t in pairs:
            name = (f"{cfg.name} {cfg.num_layers} layers {cfg.dtype} {tag} "
                    f"with {n} image tokens vs forward (seed {seed})")
            row[tag] = dict(
                max_abs_err=(check_close(name, got, want, t) if hold else
                             (got.float() - want.float()).abs().max().item()),
                limit_share=limit_share(got, want, t),
                logit_scale=want.float().abs().max().item())
        del full, pre
    return dict(batch=2, image_tokens=n, text=text, seeds=seeds, tol=tol,
                held=hold,
                launches_per_prefill={k: c for k, c in
                                      counts["prefill"].items() if c},
                launches_per_decode={k: c for k, c in
                                     counts["decode"].items() if c})


def _to_f32_in_place(tree: dict) -> None:
    """Every leaf of a parameter tree cast to f32, one leaf at a time (the
    bf16 leaf freed as its f32 copy is made)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_f32_in_place(v)
        else:
            tree[k] = v.float()


def phase_audio_vlm(smi: str) -> dict:
    """The audio and vlm families' main paths, bf16, random weights (seed
    0), at their published widths:

      * HuBERT-XLarge (48 layers, d 1280, 16 x 80 heads not causal, GELU
        ff 5120, 504 classes), the layer stack: AUDIO_TRAIN's AdamW steps
        at 4 x 1000 stub frames with ``remat="full"`` (``stack_train``:
        launches held to ``_forward_launches``, no decode launch) and one
        profiled step; the DEQ form (``DEQSettings`` defaults: 4 tied
        ``attn_mlp`` blocks x0.3, Broyden, ``shine_fallback``):
        AUDIO_DEQ_TRAIN's steps, both qN kernels and the non-causal
        prefill kernel launch, solve steps and statuses printed;
      * Pixtral-12B (40 layers, d 5120, 32/8 x 128 heads, ff 14336, vocab
        131072), text-only serving: a sync and an async drain of VLM_PLENS
        over 4 slots (async = sync bit for bit, one host wait; both
        attention kernels and rmsnorm launch); the cache check with its
        1024 image tokens (``check_image_cache``) in bf16, reported beside
        its rounding floor, then in f32 at full depth, held at TOL_F32;
      * Pixtral-12B training at full width cut to VLM_TRAIN_LAYERS layers:
        VLM_TRAIN's steps with ``attn_impl="auto"`` (the kernel forward)
        and again from the same weights with ``"flash_xla"`` (the chunked
        torch path, no kernel launch), held at ``hold_trajectory``'s
        tolerances, both peaks printed;
      * card against CPU at the smoke sizes in f32: a HuBERT train step
        pair of the layer stack and of the DEQ, a Pixtral drain (text) and
        2 train steps with images.

    Returns the launch counts of the HuBERT train steps, its DEQ steps,
    the Pixtral async drain and the auto train steps; an
    ``audio_vlm_phase_split`` line gives each part's seconds."""
    out, split = {}, {}
    t_mark = [time.perf_counter()]

    def lap(part: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[part] = now - t_mark[0]
        t_mark[0] = now

    cfg = get_config(AUDIO_ARCH)
    desc = _frontend_desc(cfg)
    params = lm.init_params(cfg, seed=0, device="cuda")
    say("audio_params", config=desc, card=smi,
        params=sum(t.numel() for t in _leaves(params)))
    tr = stack_train(params, cfg, "full", desc=desc, smi=smi, **AUDIO_TRAIN)
    if tr["counts"]["decode_attention"]:
        raise AssertionError(f"{AUDIO_ARCH}: decode launches {tr['counts']}")
    out["audio_train"] = tr["counts"]
    lap("audio_train")
    profile_train_step(params, cfg, batch=AUDIO_TRAIN["batch"],
                       seq=AUDIO_TRAIN["seq"], smi=smi)
    del params
    torch.cuda.empty_cache()
    lap("audio_profile")

    cfg = get_config(AUDIO_ARCH, deq=True)
    params = _scaled_blocks(lm.init_params(cfg, seed=0, device="cuda"), 0.3)
    deq_desc = (f"{AUDIO_ARCH} DEQ (DEQSettings defaults: 4 tied attn_mlp "
                "blocks x0.3, Broyden 12 steps, tol 1e-3, ring bf16 m=8, "
                "shine_fallback; not causal)")
    tr = stack_train(params, cfg, "full", desc=deq_desc, smi=smi,
                     **AUDIO_DEQ_TRAIN)
    c = tr["counts"]
    if any(c[k] == 0 for k in ("broyden_step", "qn_apply_multi",
                               "flash_attention", "rmsnorm")) \
            or c["decode_attention"]:
        raise AssertionError(f"{AUDIO_ARCH} DEQ: launches {c}")
    out["audio_deq_train"] = c
    del params
    torch.cuda.empty_cache()
    lap("audio_deq")

    cfg = get_config(VLM_ARCH)
    desc = _frontend_desc(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    drains = {p: _moe_drain(params, cfg, p, record=True, plens=VLM_PLENS,
                            max_len=VLM_MAX_LEN)
              for p in ("sync", "async")}
    if drains["async"]["tokens"] != drains["sync"]["tokens"]:
        raise AssertionError(f"{VLM_ARCH}: async tokens "
                             f"{drains['async']['tokens']} != sync "
                             f"{drains['sync']['tokens']}")
    check_syncs(f"{VLM_ARCH} async drain", drains["async"]["syncs"], 1)
    for name, d in drains.items():
        missing = [k for k in ("flash_attention", "decode_attention",
                               "rmsnorm") if d["counts"][k] == 0]
        if missing:
            raise AssertionError(f"{VLM_ARCH} {name}: kernels not "
                                 f"launched: {missing}")
        say("vlm_serve", config=desc, pipeline=name, card=smi,
            params=n_params, init_seconds=t_init, prompt_lens=VLM_PLENS,
            max_len=VLM_MAX_LEN,
            **{k: v for k, v in d.items() if k not in ("tokens", "syncs")})
    out["vlm_drain"] = drains["async"]["counts"]
    lap("vlm_drains")
    say("vlm_cache_check", config=f"{VLM_ARCH} {cfg.num_layers} layers "
        "bf16 (reported)", card=smi,
        **check_image_cache(params, cfg, CACHE_TOL, hold=False))
    lap("vlm_cache_bf16")
    _to_f32_in_place(params)
    torch.cuda.empty_cache()
    say("vlm_cache_check", config=f"{VLM_ARCH} {cfg.num_layers} layers "
        "float32 (held)", card=smi, **check_image_cache(
            params, dataclasses.replace(cfg, dtype="float32"),
            (TOL_F32, TOL_F32), hold=True))
    del params
    torch.cuda.empty_cache()
    lap("vlm_cache_f32")

    cfg = dataclasses.replace(get_config(VLM_ARCH),
                              num_layers=VLM_TRAIN_LAYERS)
    params = lm.init_params(cfg, seed=0, device="cuda")
    desc = (f"{VLM_ARCH} layer stack at full width, {VLM_TRAIN_LAYERS} "
            f"layers, bf16, seed 0, "
            f"{sum(t.numel() for t in _leaves(params))} params, batch of "
            f"{cfg.num_image_tokens} image + "
            f"{VLM_TRAIN['seq'] - cfg.num_image_tokens} text tokens")
    arms = {impl: stack_train(params, dataclasses.replace(
        cfg, attn_impl=impl), "full", desc=desc, smi=smi, **VLM_TRAIN)
        for impl in ("auto", "flash_xla")}
    if arms["flash_xla"]["counts"]["flash_attention"]:
        raise AssertionError(f"{VLM_ARCH} flash_xla arm: kernel launches "
                             f"{arms['flash_xla']['counts']}")
    rows = {r: [(0, x["loss"], x["grad_norm"], 0) for x in a["rows"]]
            for r, a in arms.items()}
    rel = hold_trajectory(rows["auto"], rows["flash_xla"], rows["flash_xla"])
    say("vlm_train_flash_xla", config=desc, card=smi, rel_diff=rel["replay"],
        tol="loss rtol 1e-2, grad norm rtol 5e-2 at every step "
        "(hold_trajectory)",
        peak_mem_gib={r: a["peak_mem_gib"] for r, a in arms.items()},
        step_ms={r: [x["step_ms"] for x in a["rows"]]
                 for r, a in arms.items()})
    out["vlm_train"] = arms["auto"]["counts"]
    del params
    torch.cuda.empty_cache()
    lap("vlm_train")

    say("audio_train_parity", card=smi, **stack_train_parity(AUDIO_ARCH))
    say("audio_train_parity", card=smi, **stack_train_parity(AUDIO_ARCH,
                                                             deq=True))
    say("vlm_parity", card=smi, **stack_parity(VLM_ARCH))
    say("vlm_train_parity", card=smi, **stack_train_parity(VLM_ARCH))
    lap("parity")
    say("audio_vlm_phase_split", card=smi, seconds=split)
    return out


# ---------------------------------------------------------------------------
# phase 17: layout and costing on one card
# ---------------------------------------------------------------------------

# the drains whose serving caches are held to the dry-run's bytes:
# (arch, deq, slots, max_len) of phase_serve, phase_moe, phase_hybrid,
# phase_xlstm and phase_audio_vlm
LAYOUT_DRAINS = (("minicpm-2b", True, 4, 1024),
                 ("deepseek-v2-lite-16b", False, 4, MOE_MAX_LEN),
                 ("zamba2-2.7b", False, 4, MOE_MAX_LEN),
                 ("xlstm-1.3b", False, 4, MOE_MAX_LEN),
                 ("pixtral-12b", False, 4, VLM_MAX_LEN))
# a real step's peak against the dry-run's argument_bytes + temp_bytes, as
# a fraction of the measured peak: on meta the attention takes the plain
# route (its f32 score blocks, which the kernel never holds), the qN ops
# and rmsnorm their plain versions (f32 intermediates the kernels do not
# make) and the unrolled solve selects a fresh ring every iteration; each
# is under 2% of these peaks
LAYOUT_PEAK_TOL = 0.10
LAYOUT_SHARE_MAX = 1.05
LAYOUT_STEP = dict(batch=4, seq=256, runs=3)
DRYRUN_JOBS = 6          # workers of the matrix: two of the 8 cores left over
# the matrix's cells that cannot finish beside the other phases, run with
# the dry-run's CLI (``--all``).  Seconds a cell, on an 8-core CPU host
# with PyTorch 2.13 (6 workers) / on the card's host with PyTorch 2.11 (7
# workers), PERF.md §4:
DRYRUN_EXCLUDE = (
    # the sLSTM loop over 32k tokens on meta, unsharded: 455-681 s
    "xlstm-1.3b/prefill_32k/one/memory",
    "xlstm-1.3b/train_4k/one/memory",
    # 1737 / >1200 s
    "xlstm-1.3b/prefill_32k/single/cost",
    # the sharded prefill on meta, every chunked attention tile a DTensor
    # op: 92-658 / 83-597 s each (xLSTM's 2065-2305 s)
    *(f"{a}/prefill_32k/{m}/memory" for a in (
        "minicpm-2b", "phi3-mini-3.8b", "stablelm-3b", "internlm2-20b",
        "deepseek-v2-lite-16b", "deepseek-moe-16b", "hubert-xlarge",
        "zamba2-2.7b", "xlstm-1.3b", "pixtral-12b")
      for m in ("single", "multi")),
    # sharded train steps on the two-pod mesh, 24-557 / 24-48 s each (each
    # arch keeps its single-pod or decode cells; MiniCPM-2B's DEQ step
    # stays in on both meshes)
    *(f"{a}/train_4k/multi/memory" for a in (
        "minicpm-2b", "phi3-mini-3.8b", "stablelm-3b", "internlm2-20b",
        "deepseek-v2-lite-16b", "deepseek-moe-16b", "hubert-xlarge",
        "zamba2-2.7b", "xlstm-1.3b", "pixtral-12b")),
    "deepseek-moe-16b/train_4k/multi/memory/deq",      # 27-30 / 39
    "zamba2-2.7b/train_4k/multi/memory/deq",           # 602-629 / 76
    "zamba2-2.7b/train_4k/single/memory/deq",          # 101-110 / 71
    "zamba2-2.7b/train_4k/single/cost/deq",            # 102-112 / 77
    "xlstm-1.3b/train_4k/single/memory",               # 1326 / 1014
    "xlstm-1.3b/train_4k/single/cost",                 # 1085 / 828
)
# seconds after the script's start by which the matrix must be done
DRYRUN_DEADLINE = 1000


def start_dryrun_matrix() -> tuple:
    """Start the dry-run's whole matrix in a niced subprocess (CPU only, no
    card) writing into a fresh directory; ``phase_layout`` collects it."""
    out = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
           "--jobs", str(DRYRUN_JOBS), "--out", out]
    for cell in DRYRUN_EXCLUDE:
        cmd += ["--exclude", cell]
    with open(os.path.join(out, "matrix.log"), "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT, text=True,
                                preexec_fn=lambda: os.nice(19))
    return proc, out, time.perf_counter()


def check_matrix(summary: dict, rc: int) -> None:
    """The matrix's summary line: every cell written or skipped with its
    reason, none failed."""
    if rc != 0 or summary["failures"]:
        raise AssertionError(f"dry-run matrix: rc {rc}, failed cells "
                             f"{summary['failures']}")
    if summary["ran"] + len(summary["excluded"]) != summary["cells"]:
        raise AssertionError(f"dry-run matrix ran {summary['ran']} of "
                             f"{summary['cells']} cells")


def collect_dryrun_matrix(matrix: tuple, smi: str) -> dict:
    """Wait for the matrix (at most until ``DRYRUN_DEADLINE`` seconds after
    it started) and check its summary."""
    proc, out, t0 = matrix
    wait = max(1.0, DRYRUN_DEADLINE - (time.perf_counter() - t0))
    try:
        proc.wait(timeout=wait)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(os.path.join(out, "matrix.log")) as f:
        text = f.read()
    if proc.returncode is None or proc.returncode < 0:
        raise AssertionError(f"dry-run matrix not done {DRYRUN_DEADLINE} s "
                             f"after it started: {text[-3000:]}")
    lines = text.strip().splitlines()
    try:
        summary = json.loads(lines[-1])["dryrun_all"]
    except (IndexError, ValueError, KeyError):
        raise AssertionError(f"dry-run matrix printed no summary: "
                             f"{text[-4000:]}")
    errs = {p: open(os.path.join(out, p)).read()[-1500:]
            for p in sorted(os.listdir(out)) if p.endswith(".err")}
    say("layout_matrix", cells=summary["cells"], ran=summary["ran"],
        excluded=summary["excluded"],
        failures=summary["failures"], skipped=summary["skipped"],
        seconds=summary["seconds"],
        since_start_seconds=round(time.perf_counter() - t0, 1),
        slowest=summary["slowest"], errors=errs, card=smi)
    check_matrix(summary, proc.returncode)
    return summary


# the caching allocator gives a block over 1 MiB its whole segment when the
# rest would be 1 MiB or less (it splits only a larger rest), so such a
# block may hold up to this much more than its 512-byte rounding
ALLOC_TAIL = 1 << 20


def want_bytes(tree) -> dict:
    """The dry-run's count of a tree on one card: its exact bytes, the
    bytes at each leaf's 512-byte block, and its leaves over 1 MiB."""
    leaves = [t for t, _ in dryrun.leaves_with_specs(tree)]
    return {"exact": dryrun.tree_bytes(tree, None, ONE_CARD),
            "blocks": dryrun.tree_bytes(tree, None, ONE_CARD, dryrun.BLOCK),
            "large": sum(t.numel() * t.element_size() > ALLOC_TAIL
                         for t in leaves)}


def check_bytes(name: str, got: dict, want: dict) -> dict:
    """The allocator's growth against the dry-run's count: the bytes
    requested equal its exact bytes, and the bytes allocated its 512-byte
    blocks, plus at most ``ALLOC_TAIL`` for each leaf over 1 MiB."""
    if got["requested"] != want["exact"]:
        raise AssertionError(f"{name}: {got['requested']} B requested, the "
                             f"dry-run counts {want['exact']} B")
    tail = got["allocated"] - want["blocks"]
    if not 0 <= tail <= want["large"] * ALLOC_TAIL:
        raise AssertionError(f"{name}: memory_allocated grew by "
                             f"{got['allocated']} B, the dry-run counts "
                             f"{want['blocks']} B in 512-byte blocks and "
                             f"{want['large']} leaves over 1 MiB")
    return dict(got, blocks=want["blocks"], tail=tail)


def _allocated_by(build) -> tuple:
    """``(result, {"requested", "allocated"})``: the caching allocator's
    growth over ``build()``."""
    def now():
        torch.cuda.synchronize()
        st = torch.cuda.memory_stats()
        return (st["requested_bytes.all.current"],
                st["allocated_bytes.all.current"])

    req0, alloc0 = now()
    out = build()
    req1, alloc1 = now()
    return out, {"requested": req1 - req0, "allocated": alloc1 - alloc0}


def _one_bytes(tree, specs=None) -> int:
    return dryrun.tree_bytes(tree, specs, ONE_CARD, dryrun.BLOCK)


def layout_bytes(smi: str) -> dict:
    """Parameters of every config, the DEQ train state and the drains'
    caches, each against the allocator."""
    ctx = ShardCtx.for_mesh(ONE_CARD)
    res = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        params, got = _allocated_by(
            lambda: lm.init_params(cfg, seed=0, device="cuda"))
        res[f"params/{arch}"] = check_bytes(
            f"{arch} parameters", got,
            want_bytes(train_steps.param_structs(cfg, ctx)[0]))
        del params
        torch.cuda.empty_cache()
    cfg = get_config("minicpm-2b", deq=True)
    tcfg = TrainConfig(global_batch=LAYOUT_STEP["batch"],
                       seq_len=LAYOUT_STEP["seq"], schedule=cfg.schedule)
    state, got = _allocated_by(
        lambda: train_steps.init_train_state(cfg, tcfg, device="cuda"))
    res["train_state/minicpm-2b-deq"] = check_bytes(
        "minicpm-2b DEQ train state", got,
        want_bytes(train_steps.train_state_structs(cfg, tcfg, ctx)[0]))
    del state
    for arch, deq, slots, max_len in LAYOUT_DRAINS:
        cfg = get_config(arch, deq=deq)
        caches, got = _allocated_by(
            lambda: lm.init_cache(cfg, slots, max_len, device="cuda"))
        res[f"caches/{arch}{'-deq' if deq else ''}"] = check_bytes(
            f"{arch} caches ({slots} x {max_len})", got,
            want_bytes(lm.init_cache(cfg, slots, max_len, device="meta")))
        del caches
    torch.cuda.empty_cache()
    say("layout_bytes", checked=len(res), bytes=res, card=smi)
    return res


def _median_ms(fn, runs: int) -> tuple[list, list]:
    """``fn()`` ``runs`` times: each run's CUDA-event ms and result."""
    times, outs = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(fn())
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, outs


def check_peak(name: str, predicted: int, measured: int) -> float:
    err = abs(predicted - measured) / measured
    if err > LAYOUT_PEAK_TOL:
        raise AssertionError(f"{name}: peak {measured} B, the dry-run "
                             f"predicts {predicted} B ({err:.3f} > "
                             f"{LAYOUT_PEAK_TOL})")
    return err


def check_share(name: str, share: float) -> float:
    if not 0.0 < share <= LAYOUT_SHARE_MAX:
        raise AssertionError(f"{name}: achieved share {share:.4f} of the "
                             f"card's dense bf16 peak is outside (0, "
                             f"{LAYOUT_SHARE_MAX}]")
    return share


def _step_report(name, cell, mem, flops, times, peak_adj, smi, **extra):
    pred = mem["argument_bytes_blocks"] + mem["temp_bytes"]
    err = check_peak(name, pred, peak_adj)
    rates = [f / (t * 1e-3) for f, t in zip(flops, times)]
    share = check_share(name, float(np.median(rates)) / PEAK_FLOPS["bf16"])
    out = dict(predicted_peak_bytes=pred, measured_peak_bytes=peak_adj,
               peak_rel_err=err, argument_bytes=mem["argument_bytes_blocks"],
               temp_bytes=mem["temp_bytes"], flops=flops, ms=times,
               median_ms=float(np.median(times)),
               tflops_per_s=float(np.median(rates)) / 1e12,
               share_of_bf16_peak=share, **extra)
    say("layout_step", cell=cell, card=smi, **out)
    return out


def layout_deq_train(smi: str) -> dict:
    """The MiniCPM-2B DEQ train step at 4 x 256 (phase_train's): peak and
    FLOPs against the dry-run's."""
    b, s, runs = LAYOUT_STEP["batch"], LAYOUT_STEP["seq"], LAYOUT_STEP["runs"]
    cfg = get_config("minicpm-2b", deq=True)
    tcfg = TrainConfig(global_batch=b, seq_len=s, schedule=cfg.schedule)
    shape = ShapeSuite(f"train_{b}x{s}", "train", s, b)
    mem = dryrun.run_cell("minicpm-2b", shape.name, "one", "memory",
                          deq=True, shape=shape, tcfg=tcfg)["memory"]
    cost = dryrun.run_cell("minicpm-2b", shape.name, "one", "cost",
                           deq=True, shape=shape, tcfg=tcfg)
    state = train_steps.init_train_state(
        cfg, tcfg, params=_scaled_blocks(
            lm.init_params(cfg, seed=0, device="cuda"), 0.3))
    torch.cuda.empty_cache()
    batch = next(make_lm_batch_iterator(cfg, b, s, seed=0, device="cuda"))
    step = train_steps.build_train_step(cfg, tcfg)
    args_alloc = _one_bytes(state) + _one_bytes(batch)
    holder = {"state": state}
    del state

    def run():
        holder["state"], m = step(holder["state"], batch)
        return m

    peaks = []

    def run_peak():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m = run()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base + args_alloc)
        return m

    run()  # warm-up: cuBLAS handles and workspaces, kernel loads
    times, metrics = _median_ms(run_peak, runs)
    steps_n = [float(m["deq_steps"]) for m in metrics]
    d = cost["depths"]
    per_step = cost["extrapolated"]["flops_per_layer"]
    flops = [d["2"]["flops"] + (n - 2) * per_step for n in steps_n]
    out = _step_report("minicpm-2b DEQ train step", shape.name, mem, flops,
                       times, max(peaks), smi, forward_steps=steps_n,
                       peaks=peaks, flops_per_solver_step=per_step,
                       loss=[float(m["loss"]) for m in metrics])
    del holder, batch
    torch.cuda.empty_cache()
    return out


def layout_prefill(smi: str) -> dict:
    """DeepSeek-V2-Lite's prefill at 4 x 256, full depth: peak and FLOPs
    against the dry-run's."""
    b, s, runs = LAYOUT_STEP["batch"], LAYOUT_STEP["seq"], LAYOUT_STEP["runs"]
    arch = "deepseek-v2-lite-16b"
    cfg = get_config(arch)
    shape = ShapeSuite(f"prefill_{b}x{s}", "prefill", s, b)
    mem = dryrun.run_cell(arch, shape.name, "one", "memory",
                          shape=shape)["memory"]
    cost = dryrun.run_cell(arch, shape.name, "one", "cost", shape=shape)
    params = lm.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(2, cfg.vocab_size, (b, s), generator=gen,
                           dtype=torch.int32).cuda()
    args_alloc = _one_bytes(params) + _one_bytes(tokens)
    peaks = []

    def run_peak():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = lm.prefill(params, {"tokens": tokens}, cfg, s)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base + args_alloc)
        return out[0].isfinite().all()

    lm.prefill(params, {"tokens": tokens}, cfg, s)  # warm-up
    launches.reset()
    times, finite = _median_ms(run_peak, runs)
    counts = launches.counts()
    if not all(bool(f) for f in finite):
        raise AssertionError(f"{arch} prefill: non-finite logits")
    missing = [k for k in ("flash_attention", "rmsnorm") if not counts[k]]
    if missing:
        raise AssertionError(f"{arch} prefill launched no {missing}")
    flops = [cost["extrapolated"]["flops"]] * runs
    out = _step_report(f"{arch} prefill", shape.name, mem, flops, times,
                       max(peaks), smi, peaks=peaks, launches=counts)
    del params
    torch.cuda.empty_cache()
    return out


def phase_layout(matrix: tuple, smi: str) -> dict:
    """Step 17: the dry-run's matrix, its bytes against the allocator, and
    two real steps' peaks and FLOPs against its predictions."""
    torch.cuda.empty_cache()
    res = {"bytes": layout_bytes(smi),
           "deq_train": layout_deq_train(smi),
           "prefill": layout_prefill(smi)}
    res["matrix"] = collect_dryrun_matrix(matrix, smi)
    return res


# ---------------------------------------------------------------------------
# sharded execution (torch.distributed over NCCL)
# ---------------------------------------------------------------------------

SHARDED_TRAIN = dict(batch=4, seq=256)
# the four-card world's sync drain
SHARDED_DRAIN = dict(requests=4, prompt=128, new=8, slots=4, max_len=256)
# (2, 2) local shapes of the MiniCPM-2B paths: 18 of 36 heads, B 2 of 4
SHARDED_LOCAL = dict(bsz=2, seq=256, heads=18, hd=64, rows=512, width=2304,
                     m=8, t_slice=512)
# the cross-rank decode: one cache of 1024 keys as two slices of 512; the
# lengths leave slices with no valid key
SHARDED_DECODE_LENS = (100, 700, 1024, 3)
V2_LITE_EP_CAPACITY = 8.0
# V2-Lite's bf16 prefill at full depth, sharded against unsharded: held at
# TOL_SHARDED, or, both held against an f32 prefill over the same (bf16)
# weights, the sharded one's largest error within this many times the
# unsharded one's, in the same run
EP_FLOOR_MULT = 2.0
# the (2, 2) DEQ step's first moments against one card's, each leaf's
# relative L2 error (the reference's parameter rtol, over a whole leaf)
MU_REL_L2_SHARDED = 5e-2
# sharded against one device, the reference's own tolerance for a sharded
# MoE forward and a sharded decode (tests/test_sharding.py)
TOL_SHARDED = dict(rtol=3e-2, atol=3e-2)


def sharded_cfg(smoke: bool = False):
    """The sharded phase's MiniCPM-2B DEQ: at full width, or (the four CPU
    ranks') its smoke config in f32."""
    if smoke:
        return dataclasses.replace(smoke_config("minicpm-2b", deq=True),
                                   dtype="float32")
    return get_config("minicpm-2b", deq=True)


def sharded_tcfg(cfg, grad_accum: int = 1) -> TrainConfig:
    """The sharded phase's train step: ``SHARDED_TRAIN``, ZeRO-1."""
    return TrainConfig(steps=2, global_batch=SHARDED_TRAIN["batch"],
                       seq_len=SHARDED_TRAIN["seq"], schedule=cfg.schedule,
                       zero1=True, grad_accum=grad_accum)


# the sharded phase's DEQ train steps whose collectives the dry-run counts
# on a fake world of the same mesh: (tag, mesh, smoke config), counted at
# two solver-step depths (a step's collectives are linear in the solve's
# steps) and held against the real step's at its own step count
SHARDED_DRYRUN = (("1x1", (1, 1), False), ("2x2", (2, 2), False),
                  ("2x2_cpu", (2, 2), True))
SHARDED_DRYRUN_DEPTHS = (2, 4)


def issued(records) -> dict:
    """``kind -> [count, per-device link bytes]`` of issued collectives
    (``(kind, result bytes, group size)`` triples); a group of one counts,
    with 0 bytes."""
    out: dict = {}
    for kind, n, g in records:
        c = out.setdefault(kind, [0, 0.0])
        c[0] += 1
        if g > 1 or kind == "collective-permute":
            c[1] += dryrun.RING[kind](n, g)
    return out


def comm_kinds(comms: dict) -> dict:
    """``CommDebugMode``'s counts by op name as ``issued``'s kinds (no
    bytes)."""
    out: dict = {}
    for name, n in comms.items():
        out.setdefault(dryrun.collective_kind(name), [0, 0.0])[0] += n
    return out


def sharded_step_counts(tags=None) -> dict:
    """(On the CPU, no card.)  The dry-run of the sharded phase's DEQ train
    step on a fake world of each ``SHARDED_DRYRUN`` mesh (those of
    ``tags``; None: all), as the step runs (no unroll: on ``meta`` every
    stop test reads as not met, so the solve runs its ``max_steps`` and
    issues each test): its collectives at ``SHARDED_DRYRUN_DEPTHS`` solver
    steps; at (2, 2) full width also the memory cell at the config's
    ``max_steps``."""
    shape = ShapeSuite("train_4x256", "train", SHARDED_TRAIN["seq"],
                       SHARDED_TRAIN["batch"])
    res = {}
    for tag, dims, smoke in SHARDED_DRYRUN:
        if tags is not None and tag not in tags:
            continue
        cfg = sharded_cfg(smoke)
        tcfg = sharded_tcfg(cfg)
        mesh = MeshSpec(("data", "model"), dims)
        entry = {"max_steps": cfg.deq.max_steps, "depths": {}}
        t0 = time.perf_counter()
        with dryrun.fake_world(mesh) as world:
            for n in SHARDED_DRYRUN_DEPTHS:
                ncfg = dataclasses.replace(cfg, deq=dataclasses.replace(
                    cfg.deq, max_steps=n))
                _, _, rec = dryrun.run_step(dryrun.build_cell(
                    ncfg, shape, world, tcfg))
                entry["depths"][str(n)] = issued(rec)
            if tag == "2x2":
                mem = dryrun.memory_cell(cfg, shape, mesh, tcfg, run=True,
                                         world=world)
                entry["memory"] = {k: mem[k] for k in (
                    "argument_bytes", "argument_bytes_blocks",
                    "temp_bytes")}
        entry["seconds"] = time.perf_counter() - t0
        res[tag] = entry
    return res


def sharded_step_dryrun(out_path: str) -> None:
    """``sharded_step_counts()`` written to ``out_path`` as JSON."""
    with open(out_path, "w") as f:
        json.dump(sharded_step_counts(), f)


def start_sharded_dryrun() -> tuple:
    """Start ``sharded_step_dryrun`` in a niced subprocess (CPU only);
    ``collect_sharded_dryrun`` waits for it."""
    out = tempfile.mkdtemp(prefix="sharded_dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import sys, chip_smoke; "
            "chip_smoke.sharded_step_dryrun(sys.argv[1])")
    with open(os.path.join(out, "log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, os.path.join(out, "counts.json")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            text=True, preexec_fn=lambda: os.nice(19))
    return proc, out


def collect_sharded_dryrun(handle: tuple, timeout: float = 600) -> dict:
    proc, out = handle
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    path = os.path.join(out, "counts.json")
    if proc.returncode != 0 or not os.path.exists(path):
        with open(os.path.join(out, "log")) as f:
            raise AssertionError(f"the sharded step's dry-run failed "
                                 f"(rc {proc.returncode}): "
                                 f"{f.read()[-4000:]}")
    with open(path) as f:
        res = json.load(f)
    shutil.rmtree(out, ignore_errors=True)
    return res


def expected_issued(entry: dict, n: int, stop_group: int) -> dict:
    """The dry-run's collectives of the step at ``n`` solver steps: linear
    in the steps between its two counted depths.  A solve that stopped
    before its ``max_steps`` also read the test that stopped it: one more
    all-reduce of one int32 over the ``stop_group`` ranks."""
    (l0, d0), (l1, d1) = sorted((int(k), v)
                                for k, v in entry["depths"].items())
    out = {}
    for kind in set(d0) | set(d1):
        a, b = d0.get(kind, [0, 0.0]), d1.get(kind, [0, 0.0])
        out[kind] = [a[i] + (n - l0) * (b[i] - a[i]) / (l1 - l0)
                     for i in (0, 1)]
    if n < entry["max_steps"]:
        c = out.setdefault("all-reduce", [0, 0.0])
        c[0] += 1
        if stop_group > 1:
            c[1] += dryrun.RING["all-reduce"](4, stop_group)
    return out


def check_issued(name: str, got: dict, want: dict,
                 with_bytes: bool) -> None:
    """The collectives a real step issued against the dry-run's: the same
    kinds and counts, and (``with_bytes``) the same link bytes."""
    zero = [0, 0.0]
    bad = {k: (got.get(k, zero), want.get(k, zero))
           for k in set(got) | set(want)
           if got.get(k, zero)[0] != want.get(k, zero)[0]
           or (with_bytes and not math.isclose(
               got.get(k, zero)[1], want.get(k, zero)[1], rel_tol=1e-9,
               abs_tol=1e-6))}
    if bad:
        raise AssertionError(f"{name}: the step's collectives are not the "
                             f"dry-run's (got, dry-run): {bad}")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _comm_counts(fn):
    """``fn()`` under ``CommDebugMode``: its result and the collectives it
    issued (DTensor's and the c10d calls), by op name."""
    from torch.distributed.tensor.debug import CommDebugMode
    mode = CommDebugMode()
    with mode:
        out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {str(k).split(".")[-1]: v
                 for k, v in mode.get_comm_counts().items()}


def _leaf_diff(a: dict, b: dict, atol: float) -> dict:
    """Over the leaves of two parameter trees (DTensors gathered): the
    largest |a - b|, the elements that differ at all, and the largest
    excess over ``atol``."""
    from repro_torch.parallel.sharding import full_tree
    la = train_steps.tree_leaves(full_tree(a))
    lb = train_steps.tree_leaves(full_tree(b))
    return dict(
        leaves=len(la),
        max_abs_diff=max((x.float() - y.float()).abs().max().item()
                         for x, y in zip(la, lb)),
        differing=sum(int((x != y).sum()) for x, y in zip(la, lb)),
        excess=max(excess(x, y, dict(rtol=0.0, atol=atol))
                   for x, y in zip(la, lb)))


def _moment_diff(got, want, rtol: float, rel_atol: float) -> dict:
    """Adam's first moments after the first step, mu = (1 - b1) g, leaf by
    leaf (``got``'s DTensors gathered, ``want``'s leaves moved to ``got``'s
    device one at a time): the elements that differ at all, the largest
    excess over ``rtol`` with an atol of ``rel_atol`` times the leaf's
    largest entry, and the largest relative L2 error.  A leaf updated from
    a wrong or a missing gradient shows here; in its parameter it need not
    (Adam's first update is lr times about the gradient's sign)."""
    from repro_torch.parallel.sharding import full_tree
    lg = train_steps.tree_leaves(full_tree(got))
    lw = train_steps.tree_leaves(want)
    out = dict(leaves=len(lg), differing=0, excess=-math.inf, rel_l2=0.0)
    for g, w in zip(lg, lw):
        g, w = g.float(), w.to(g.device).float()
        out["differing"] += int((g != w).sum())
        out["excess"] = max(out["excess"], excess(g, w, dict(
            rtol=rtol, atol=rel_atol * w.abs().max().item())))
        out["rel_l2"] = max(out["rel_l2"], ((g - w).norm() / w.norm().clamp_min(
            torch.finfo(torch.float32).tiny)).item())
    return out


def _step_seconds(step, state, batch) -> float:
    """The wall time of one more step (the state's second), to its last
    kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sharded_train_step(cfg, params, ctx, smi: str, tag: str,
                       grad_accum: int = 1, record: dict | None = None
                       ) -> dict:
    """One MiniCPM-2B DEQ train step (4 x 256, ZeRO-1; ``grad_accum``
    microbatches) through ``ctx``; the unsharded step first (its loss, grad
    norm, parameters and first moments kept on the host), then the sharded
    one.  On a mesh of one
    device the sharded step runs the same kernels on the same tensors in
    the same order: held are the forward steps (equal), the loss at rtol
    1e-5, the grad norm at 1e-4, every parameter element bit for bit, and
    every leaf's first moment (the gradient, which the parameter's first
    update mostly does not show) at rtol 1e-4 with an atol of 1e-4 x the
    leaf's largest entry.  Then the second step of
    each, timed, and a third under the profiler: wall, device busy time
    and idle share.  ``record`` takes the sharded first step's collectives
    (``CommDebugMode``'s counts) and solve steps."""
    tcfg = sharded_tcfg(cfg, grad_accum)
    batch = next(make_lm_batch_iterator(cfg, tcfg.global_batch,
                                        tcfg.seq_len, seed=0, device="cuda"))
    # under accumulation the step reports no solve steps (the reference's
    # microbatch scan drops them): 0 on both arms
    keys = ("loss", "grad_norm", "deq_steps", "lr")
    s0 = train_steps.init_train_state(cfg, tcfg, params=params)
    step0 = train_steps.build_train_step(cfg, tcfg)
    s0, m0 = step0(s0, batch)
    want = train_steps.tree_map(lambda t: t.cpu(), s0.params)
    want_mu = train_steps.tree_map(lambda t: t.cpu(), s0.opt.mu)
    t_plain = _step_seconds(step0, s0, batch)
    prof_plain = _profile_window(lambda: step0(s0, batch), host_ops=False)
    m0 = {k: float(m0.get(k, 0.0)) for k in keys}
    del s0
    torch.cuda.empty_cache()
    s1 = train_steps.init_train_state(cfg, tcfg, params=params, ctx=ctx)
    step = train_steps.build_train_step(cfg, tcfg, ctx=ctx)
    launches.reset()
    t0 = time.perf_counter()
    (s1, m1), comms = _comm_counts(lambda: step(s1, batch))
    secs = time.perf_counter() - t0
    counts = launches.counts()
    m1 = {k: float(m1.get(k, 0.0)) for k in keys}
    diff = _leaf_diff(train_steps.tree_map(lambda t: t.cuda(), want),
                      s1.params, m0["lr"] / 10)
    mu = _moment_diff(s1.opt.mu, want_mu, 1e-4, 1e-4)
    del want, want_mu
    t_sharded = _step_seconds(step, s1, batch)
    prof = _profile_window(lambda: step(s1, batch), host_ops=False)
    moments = train_steps.tree_leaves(s1.opt.mu)
    say("sharded_train", mesh=dict(ctx.mesh.shape), grad_accum=grad_accum,
        unsharded=m0, sharded=m1,
        bit_for_bit=(m1 == m0 and diff["differing"] == 0),
        params=diff, first_moments=mu, seconds_first_with_comm_debug=secs,
        seconds_second_step_unsharded=t_plain,
        seconds_second_step_sharded=t_sharded,
        moments_placements=str(moments[0].placements),
        ring_placements=(str(s1.carry.lowrank.u.placements)
                         if s1.carry is not None else None), card=smi)
    for arm, p in (("unsharded", prof_plain), ("sharded", prof)):
        say("sharded_train_profile", arm=arm, mesh=dict(ctx.mesh.shape),
            grad_accum=grad_accum, window="third step", card=smi, **p)
    say("sharded_train_collectives", mesh=dict(ctx.mesh.shape),
        grad_accum=grad_accum, **comms)
    if record is not None:
        record.update(comms=comms, deq_steps=m1["deq_steps"])
    if (m1["deq_steps"] != m0["deq_steps"]
            or abs(m1["loss"] - m0["loss"]) > 1e-5 * abs(m0["loss"])
            or abs(m1["grad_norm"] - m0["grad_norm"])
            > 1e-4 * abs(m0["grad_norm"]) or diff["differing"]
            or mu["excess"] > 0):
        raise AssertionError(f"{tag}: the sharded step is not the "
                             f"unsharded one: {m0} {m1} {diff} {mu}")
    del s1
    torch.cuda.empty_cache()
    return counts


# the serving arms on a mesh: the two sync arms of PREFIX_ARMS, async at
# depth 2 without a prefix cache and with the device store; over the first
# 8 prompts of ``prefix_stream`` (4 bases, then each again: an exact hit),
# solves stopped at PREFIX_TOL as in ``phase_serve_prefix``
SHARDED_PREFIX = dict(prompts=8, new=8, slots=4, max_len=1024)
SHARDED_ARMS = {
    "a_sync": PREFIX_ARMS["a_sync"],
    "b_sync_prefix": PREFIX_ARMS["b_sync_prefix"],
    "async": dict(pipeline="async", async_depth=2),
    "c_async_prefix": PREFIX_ARMS["c_async_prefix"],
}


def _mesh_drain(params, cfg, prompts: list, kw: dict, ctxs=None) -> dict:
    """One drain of ``prompts`` through a fresh ``ServeLoop(**kw)`` (on
    the mesh of ``ctxs`` = (decode ctx, prefill ctx), if given), with the
    metrics registry and the launch counts reset just before, the host
    waits counted (``count_syncs``) and, on the mesh, the collectives by op
    (``CommDebugMode``)."""
    from torch.distributed.tensor.debug import CommDebugMode
    d = SHARDED_PREFIX
    extra = {} if ctxs is None else dict(ctx=ctxs[0], prefill_ctx=ctxs[1])
    loop = ServeLoop(params, cfg, slots=d["slots"], max_len=d["max_len"],
                     **kw, **extra)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=d["new"])
            for i, p in enumerate(prompts)]
    obs_metrics.default_registry().reset()
    syncs: list = []
    mode = CommDebugMode() if ctxs is not None else contextlib.nullcontext()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    with count_syncs(syncs), mode:
        loop.drain(reqs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cache = loop.prefix if loop.prefix is not None else loop.prefix_store
    return dict(
        loop=loop, seconds=secs, tokens=[r.out for r in reqs],
        errors=[r.error for r in reqs],
        hits=cache.stats()["hits"] if cache is not None else 0,
        prefill_steps=[w["steps"] for w in loop.solve_log
                       if w["phase"] == "prefill"],
        prefill_iters=loop.prefill_iters, saved_iters=loop.saved_iters,
        steps={str(k): v for k, v in loop.recorded_steps.items()},
        syncs=syncs, launches=launches.counts(),
        collectives=({str(k).split(".")[-1]: v
                      for k, v in mode.get_comm_counts().items()}
                     if ctxs is not None else None))


def check_mesh_arm(name: str, got: dict, want: dict, pipeline: str,
                   max_steps: int) -> None:
    """A serving arm on the mesh against the same arm unsharded: every
    request served in full without an error, the same tokens bit for bit,
    the same prefix hits, prefill step sequence and prefill iterations
    (spent and saved) and per-request step sequences; an async arm waits
    for the card only for the solver's reads and the clock
    (``async_expected_syncs``), on the mesh as without it."""
    for uid, (out, err) in enumerate(zip(got["tokens"], got["errors"])):
        if len(out) != SHARDED_PREFIX["new"] or err is not None:
            raise AssertionError(f"{name} on the mesh, request {uid}: "
                                 f"{len(out)} tokens, error {err}")
    for key in ("tokens", "hits", "prefill_steps", "prefill_iters",
                "saved_iters", "steps"):
        if got[key] != want[key]:
            raise AssertionError(f"{name}: {key} on the mesh {got[key]}, "
                                 f"unsharded {want[key]}")
    if pipeline == "async":
        for arm, a in (("mesh", got), ("unsharded", want)):
            check_syncs(f"{name} {arm}", a["syncs"], async_expected_syncs(
                a["loop"].solve_log, max_steps))


def sharded_serve_arms(cfg, params, ctxs, smi: str) -> dict:
    """``SHARDED_ARMS`` on the mesh of ``ctxs`` against each arm
    unsharded (``check_mesh_arm``), then each mesh arm once more under the
    profiler: wall, device busy time, idle share.  Returns the mesh arms'
    launch counts, summed."""
    prompts = prefix_stream(cfg.vocab_size)[:SHARDED_PREFIX["prompts"]]
    cfg = dataclasses.replace(cfg, deq=dataclasses.replace(cfg.deq,
                                                           tol=PREFIX_TOL))
    sharded = lm.place_params(params, cfg, ctxs[0])
    counts = collections.Counter()
    for name, kw in SHARDED_ARMS.items():
        want = _mesh_drain(params, cfg, prompts, kw)
        got = _mesh_drain(sharded, cfg, prompts, kw, ctxs)
        check_mesh_arm(name, got, want, kw["pipeline"], cfg.deq.max_steps)
        counts.update(got["launches"])
        store = got["loop"].prefix_store
        del got["loop"], want["loop"]
        torch.cuda.empty_cache()

        def plain():
            loop = ServeLoop(sharded, cfg, slots=SHARDED_PREFIX["slots"],
                             max_len=SHARDED_PREFIX["max_len"], ctx=ctxs[0],
                             prefill_ctx=ctxs[1], **kw)
            loop.drain([Request(uid=i, prompt=list(p),
                                max_new_tokens=SHARDED_PREFIX["new"])
                        for i, p in enumerate(prompts)])

        prof = _profile_window(plain, host_ops=False)
        say("sharded_serve_arm", arm=name, mesh=dict(ctxs[0].mesh.shape),
            card=smi, tol=PREFIX_TOL, pipeline=kw["pipeline"],
            same_as_unsharded=True, tokens=sum(map(len, got["tokens"])),
            seconds_sharded=got["seconds"], seconds_unsharded=want["seconds"],
            hits=got["hits"], prefill_steps=got["prefill_steps"],
            prefill_iters=got["prefill_iters"],
            saved_iters=got["saved_iters"], host_waits=len(got["syncs"]),
            host_waits_unsharded=len(want["syncs"]),
            launches={k: n for k, n in got["launches"].items() if n},
            collectives=got["collectives"],
            store_bytes=store.nbytes() if store is not None else None,
            profiled={k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                           "idle_share", "kernel_launches")})
        torch.cuda.empty_cache()
    obs_metrics.default_registry().reset()
    return counts


def kernels_at_local_shapes(smi: str) -> dict:
    """The five kernels of the sharded path at what a (2, 2) mesh gives
    each rank, against their plain versions; and the cross-rank decode:
    two 512-key slices' partials, gathered and combined in one process,
    against the decode over the whole cache."""
    g = torch.Generator(device="cuda").manual_seed(11)
    L = SHARDED_LOCAL
    bf = torch.bfloat16
    out = {}
    q, k, v = _attn_inputs(g, L["bsz"], L["seq"], L["seq"], L["heads"],
                           L["heads"], L["hd"], bf)
    out["flash_attention"] = check_close(
        "attention (2,2) local", ops.attention(q, k, v, causal=True),
        ref.attention_ref(q, k, v, causal=True), _tol(bf, False))
    x = torch.randn((L["rows"], L["width"]), generator=g, device="cuda",
                    dtype=bf)
    w = torch.randn((L["width"],), generator=g, device="cuda", dtype=bf)
    out["rmsnorm"] = check_close(
        "rmsnorm (2,2) local", ops.rmsnorm(x, w, 1e-5),
        ref.rmsnorm_ref(x, w, 1e-5), dict(rtol=2e-2, atol=2e-2))
    dim = L["seq"] * L["width"]
    inp = qn_case_inputs(L["m"], L["bsz"], dim, bf, g)
    out["qn_apply_multi"] = qn_case("qn (2,2) local", L["m"], L["bsz"], dim,
                                    bf, None, g, inputs=inp)
    out["broyden_step"] = out["qn_apply_multi"]
    # decode: one 1024-key cache, as two ranks' slices of 512
    bsz = len(SHARDED_DECODE_LENS)
    qd, kd, vd = _decode_inputs(g, bsz, 36, 36, L["hd"], 2 * L["t_slice"],
                                bf)
    lens = torch.tensor(SHARDED_DECODE_LENS, dtype=torch.int32,
                        device="cuda")
    whole = ref.decode_attention_ref(qd, kd, vd, lens)
    parts = []
    for r in range(2):
        t0 = r * L["t_slice"]
        sl = slice(t0, t0 + L["t_slice"])
        ll = torch.clamp(lens - t0, 0, L["t_slice"])
        p = ops.decode_partials(qd, kd[:, sl].contiguous(),
                                vd[:, sl].contiguous(), ll)
        pr = ref.decode_partials_ref(qd, kd[:, sl], vd[:, sl], ll)
        # a slice with no valid key adds nothing
        empty = ll == 0
        if (p[empty][..., 1] != 0).any():
            raise AssertionError("decode partials of an empty slice")
        live = ~empty
        check_close(f"decode partials slice {r}",
                    ref.decode_combine_ref(p)[live].to(bf),
                    ref.decode_combine_ref(pr)[live].to(bf), _tol(bf, True))
        parts.append(p)
    got = ops.decode_combine(torch.cat(parts, dim=2), bf)
    out["decode_attention"] = check_close(
        "decode across two slices", got, whole, _tol(bf, True))
    say("sharded_kernels", local_shapes=L, decode_lens=SHARDED_DECODE_LENS,
        max_abs_err=out, card=smi)
    return out


# the vocab-parallel loss at (2, 2): a rank's rows (2 x 256) at its half
# of MiniCPM-2B's padded vocab (122880 / 2), bf16 logits
SHARDED_LOSS = dict(rows=512, cols=61440)
SHARDED_LOSS_TOL = dict(rtol=1e-5, atol=0.0)


def loss_shard_on_card(smi: str) -> dict:
    """The vocab-parallel loss's per-rank function
    (``layers._ShardLogPartition``, no group: a shard's own log-partition
    and gold logit) on a (2, 2) rank's bf16 logits, ``SHARDED_LOSS``,
    targets ``-1`` among them, against the plain loss (``_ce_sums``, f32
    inside, autograd): the NLL and squared log-partition sums at
    ``SHARDED_LOSS_TOL``, the logits' gradient at bf16's; the bytes each
    allocates over its inputs for forward and backward, in f32 copies of
    the shard, and each one's time."""
    from repro_torch.models.layers import (
        _ce_sums,
        _masked_sums,
        _ShardLogPartition,
    )
    g = torch.Generator(device="cuda").manual_seed(12)
    r, c = SHARDED_LOSS["rows"], SHARDED_LOSS["cols"]
    x = (3 * torch.randn((r, c), generator=g, device="cuda")).to(
        torch.bfloat16)
    t = torch.randint(-1, c, (r,), generator=g, device="cuda")

    def split(xi):
        return _masked_sums(*_ShardLogPartition.apply(xi, t, 0, []), t)[:2]

    def plain(xi):
        return _ce_sums(xi, t)[:2]

    def run(fn):
        xi = x.detach().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        nll, zl = fn(xi)
        (nll + 1e-4 * zl).backward()
        torch.cuda.synchronize()
        return nll, zl, xi.grad, torch.cuda.max_memory_allocated() - base

    got, want = run(split), run(plain)
    out = dict(shape=SHARDED_LOSS, card=smi)
    for i, name in enumerate(("nll", "z")):
        out[name] = check_close(f"vocab shard loss {name}", got[i], want[i],
                                SHARDED_LOSS_TOL)
    out["grad"] = check_close("vocab shard loss gradient", got[2], want[2],
                              _tol(torch.bfloat16, False))
    unit = r * c * 4
    out["f32_copies"] = dict(split=got[3] / unit, plain=want[3] / unit)
    for name, fn in (("split", split), ("plain", plain)):
        xi = x.detach().requires_grad_(True)
        out[f"{name}_ms"] = time_ms(lambda: sum(fn(xi)).backward(), iters=5,
                                    warmup=1)
    say("sharded_loss_shard", **out)
    return out


def phase_sharded(smi: str, step_dryrun: tuple) -> dict:
    """A world of one rank over NCCL, mesh (data=1, model=1): the DEQ
    train step, the serving arms of ``SHARDED_ARMS`` (both pipelines,
    both prefix caches) and the train step with gradient accumulation
    through the sharded code against the unsharded ones, every kernel of
    the serving path launched through ``local_map``; the kernels
    at the (2, 2) local shapes; then, on a host with four cards, four
    ranks at (2, 2).  Prints the seconds of each part
    (``sharded_phase_split``).  The first DEQ step's collectives, at (1, 1)
    and at (2, 2), are held against the dry-run's count of the same step
    (``step_dryrun``: ``start_sharded_dryrun``'s subprocess)."""
    import torch.distributed as dist

    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch.mesh import (
        MeshSpec,
        build_device_mesh,
        init_distributed,
    )
    init_distributed("cuda", init_method=f"tcp://localhost:{_free_port()}",
                     rank=0, world_size=1)
    try:
        mesh = build_device_mesh(MeshSpec(("data", "model"), (1, 1)), "cuda")
        say("sharded_world", backend=str(dist.get_backend()),
            world=dist.get_world_size(), mesh=str(mesh))
        cfg = get_config("minicpm-2b", deq=True)
        params = _scaled_blocks(lm.init_params(cfg, seed=0, device="cuda"),
                                0.3)
        tctx = make_ctx(cfg, mesh, SHAPES["train_4k"])
        ctxs = (make_ctx(cfg, mesh, SHAPES["decode_32k"]),
                make_ctx(cfg, mesh, SHAPES["prefill_32k"]))
        counts = collections.Counter()
        split = {}
        first: dict = {}
        for part, run in (
                ("train", lambda: sharded_train_step(
                    cfg, params, tctx, smi, "(1,1) DEQ step",
                    record=first)),
                ("serve_arms", lambda: sharded_serve_arms(cfg, params, ctxs,
                                                          smi)),
                ("train_accum", lambda: sharded_train_step(
                    cfg, params, tctx, smi, "(1,1) DEQ step, grad_accum 2",
                    grad_accum=2))):
            t0 = time.perf_counter()
            c = run()
            torch.cuda.synchronize()
            split[part] = time.perf_counter() - t0
            counts.update(c)
            if part == "serve_arms":
                missing = [k for k in SERVE_PATH if c[k] == 0]
                if missing:
                    raise AssertionError(f"kernels not launched by the "
                                         f"serving arms on the mesh: "
                                         f"{missing}")
        say("sharded_launches", **counts)
        say("sharded_phase_split", card=smi, seconds=split)
        expect = collect_sharded_dryrun(step_dryrun)
        n = int(first["deq_steps"])
        got, want = comm_kinds(first["comms"]), expected_issued(
            expect["1x1"], n, 1)
        say("sharded_dryrun_check", mesh={"data": 1, "model": 1},
            forward_steps=n, issued=got, dryrun=want,
            dryrun_seconds={k: v["seconds"] for k, v in expect.items()},
            card=smi)
        check_issued("(1,1) DEQ step", got, want, with_bytes=False)
        del params
        torch.cuda.empty_cache()
        errs = kernels_at_local_shapes(smi)
        loss_shard_on_card(smi)
    finally:
        dist.destroy_process_group()
    n = torch.cuda.device_count()
    if n >= 4:
        four = sharded_four_cards(smi, expect=expect["2x2"])
    else:
        say("sharded_four_cards", ran=False,
            why=f"this host has {n} card(s); the (2, 2) branch needs 4")
        # the branch's code at (2, 2) on this host's PyTorch: four gloo
        # ranks on the CPU at the smoke configs (no card, no timing)
        four = sharded_four_cards(smi, device="cpu",
                                  expect=expect["2x2_cpu"])
        four["v2_lite_bf16_error_one_card"] = v2_lite_bf16_error(smi)
    return {"counts": dict(counts), "errs": errs, "four": four}


def sharded_four_cards(smi: str, device: str = "cuda",
                       expect: dict | None = None) -> dict:
    """Four ranks over NCCL at (2, 2): the DEQ step, alone and with two
    microbatches, against the unsharded step on one card at the
    reference's tolerances (its first moments within ``MU_REL_L2_SHARDED``
    a leaf), the sync decode drain and the async drain with the device
    prefix store against the unsharded drains' tokens, and
    DeepSeek-V2-Lite's prefill through the expert-parallel branch (32
    experts a rank) against the unsharded prefill.  ``device`` "cpu" runs
    the same plumbing on four gloo ranks at the smoke configs (f32).
    ``expect`` (``sharded_step_dryrun``'s entry for the mesh): the DEQ
    step's collectives (kinds, counts, link bytes) held against the
    dry-run's, and on the cards each rank's peak against its
    ``argument_bytes + temp_bytes``."""
    import torch.multiprocessing as mp
    out = tempfile.mkdtemp(prefix="sharded4_")
    pc = mp.start_processes(_four_card_rank, args=(_free_port(), out, device),
                            nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + 400
    try:
        while not pc.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError("the four-card world ran past 400 s")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
    with open(os.path.join(out, "result.json")) as f:
        res = json.load(f)
    shutil.rmtree(out, ignore_errors=True)
    if device == "cuda":
        say("sharded_four_cards", ran=True, card=smi, **res)
    else:
        say("sharded_four_cpu_ranks", ran=True, backend="gloo",
            configs="smoke, f32", **res)
    # held: no drops; the f32 prefill at the reference's tolerance; the
    # bf16 full-depth one at it or, against f32, within EP_FLOOR_MULT of
    # the unsharded bf16 prefill's own error
    if (res["train"].get("fail") or res["train_accum"].get("fail")
            or not res["drain"]["same_tokens"]
            or not res["drain_async_store"]["same_tokens"]
            or res["drain_async_store"]["errors"]
            or not res["v2_lite_prefill_f32_4_layers"]["held"]
            or not res["v2_lite_prefill_full"]["held"]):
        raise AssertionError(f"the (2, 2) world disagrees: {res}")
    if expect is not None:
        t = res["train"]
        want = expected_issued(expect, int(t["deq_steps"]), 4)
        check_issued(f"(2,2) DEQ step ({device})", t["issued"], want,
                     with_bytes=True)
        check = dict(device=device, issued=t["issued"], dryrun=want)
        if device == "cuda":
            mem = expect["memory"]
            pred = mem["argument_bytes_blocks"] + mem["temp_bytes"]
            check.update(predicted_peak_bytes=pred, peaks=t["peaks"],
                         peak_rel_err=[check_peak(
                             f"(2,2) DEQ step, rank {r}", pred, pk)
                             for r, pk in enumerate(t["peaks"])])
        say("sharded_dryrun_check", mesh={"data": 2, "model": 2},
            forward_steps=t["deq_steps"], card=smi, **check)
    return res


def _four_card_rank(rank: int, port: int, out: str, dev: str) -> None:
    import torch.distributed as dist

    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch.mesh import (
        MeshSpec,
        build_device_mesh,
        init_distributed,
    )
    from repro_torch.parallel.sharding import full_tree
    init_distributed(dev, init_method=f"tcp://localhost:{port}",
                     rank=rank, world_size=4)
    mesh = build_device_mesh(MeshSpec(("data", "model"), (2, 2)), dev)

    def config(arch, **kw):
        if dev == "cuda":
            return get_config(arch, **kw)
        torch.set_num_threads(1)
        return dataclasses.replace(smoke_config(arch, **kw), dtype="float32")

    res = {}
    cfg = config("minicpm-2b", deq=True)
    params = _scaled_blocks(lm.init_params(cfg, seed=0, device=dev), 0.3)
    ctx = make_ctx(cfg, mesh, SHAPES["train_4k"])
    for key, k in (("train", 1), ("train_accum", 2)):
        out_t = _four_card_step(cfg, params, ctx, rank, dev, k)
        if rank == 0:
            res[key] = out_t
    # the decode drain at (2, 2)
    d = SHARDED_DRAIN
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=d["prompt"]).tolist()
               for _ in range(d["requests"])]
    dctx = make_ctx(cfg, mesh, SHAPES["decode_32k"])
    pctx = make_ctx(cfg, mesh, SHAPES["prefill_32k"])
    reqs = [Request(uid=i, prompt=p, max_new_tokens=d["new"])
            for i, p in enumerate(prompts)]
    ServeLoop(lm.place_params(params, cfg, dctx), cfg, slots=d["slots"],
              max_len=d["max_len"], pipeline="sync", ctx=dctx,
              prefill_ctx=pctx).drain(reqs)
    if rank == 0:
        want = [Request(uid=i, prompt=p, max_new_tokens=d["new"])
                for i, p in enumerate(prompts)]
        ServeLoop(params, cfg, slots=d["slots"], max_len=d["max_len"],
                  pipeline="sync").drain(want)
        res["drain"] = dict(same_tokens=[r.out for r in reqs]
                            == [r.out for r in want])
    # the async pipeline with the device store at (2, 2): SHARDED_PREFIX's
    # prompts, solves stopped at PREFIX_TOL
    pcfg = dataclasses.replace(cfg, deq=dataclasses.replace(cfg.deq,
                                                            tol=PREFIX_TOL))
    prompts = prefix_stream(cfg.vocab_size)[:SHARDED_PREFIX["prompts"]]
    kw = SHARDED_ARMS["c_async_prefix"]
    got = _mesh_drain(lm.place_params(params, pcfg, dctx), pcfg, prompts, kw,
                      (dctx, pctx))
    if rank == 0:
        want = _mesh_drain(params, pcfg, prompts, kw)
        res["drain_async_store"] = dict(
            same_tokens=got["tokens"] == want["tokens"],
            **{f"{k}{tag}": a[k] for tag, a in (("", got),
                                                 ("_unsharded", want))
               for k in ("hits", "prefill_steps", "saved_iters",
                         "seconds")},
            errors=[e for e in got["errors"] if e is not None],
            collectives=got["collectives"])
        del want
    del got, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    # DeepSeek-V2-Lite's prefill through the expert-parallel branch: held
    # in f32 at 4 layers, reported in bf16 at full depth beside the
    # unsharded bf16 prefill's own rounding floor
    base, toks = _v2_lite_ep_inputs(config("deepseek-v2-lite-16b"), dev)
    for tag, vcfg, mult in (("f32_4_layers", dataclasses.replace(
            base, num_layers=4, dtype="float32"), None),
            ("full", base, EP_FLOOR_MULT)):
        out_v = _ep_prefill(vcfg, toks, mesh, rank, dev, mult)
        if rank == 0:
            res[f"v2_lite_prefill_{tag}"] = out_v
    if rank == 0:
        with open(os.path.join(out, "result.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _four_card_step(cfg, params, ctx, rank: int, dev: str, k: int):
    """The DEQ train step (4 x 256, ZeRO-1, ``k`` microbatches) at (2, 2)
    against rank 0's unsharded step at the reference's tolerances (every
    parameter at 5e-2 / 5e-4, the loss at 2e-2, each leaf's first moment
    within ``MU_REL_L2_SHARDED``): rank 0's record, ``fail`` set if not
    held; None on the other ranks."""
    import torch.distributed as dist

    from repro_torch.parallel.sharding import full_tree
    tcfg = sharded_tcfg(cfg, k)
    batch = next(make_lm_batch_iterator(cfg, tcfg.global_batch,
                                        tcfg.seq_len, seed=0, device=dev))
    s1 = train_steps.init_train_state(cfg, tcfg, params=params, ctx=ctx)
    step = train_steps.build_train_step(cfg, tcfg, ctx=ctx)
    peak = None
    if dev == "cuda":
        torch.cuda.synchronize()
        args_alloc = _local_bytes(s1) + _local_bytes(batch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with dryrun.Collectives() as coll:
        (s1, m1), comms = _comm_counts(lambda: step(s1, batch))
    if dev == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base + args_alloc
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    p1, mu1 = full_tree(s1.params), full_tree(s1.opt.mu)
    # the second step's wall time, to its last kernel (every rank steps)
    t0 = time.perf_counter()
    step(s1, batch)
    if dev == "cuda":
        torch.cuda.synchronize()
    second = time.perf_counter() - t0
    del s1
    out = None
    if rank == 0:
        s0 = train_steps.init_train_state(cfg, tcfg, params=params)
        s0, m0 = train_steps.build_train_step(cfg, tcfg)(s0, batch)
        worst = 0.0
        for a, b in zip(train_steps.tree_leaves(p1),
                        train_steps.tree_leaves(s0.params)):
            worst = max(worst, excess(a, b, dict(rtol=5e-2, atol=5e-4)))
        mu = _moment_diff(mu1, s0.opt.mu, 5e-2, 5e-2)
        # under accumulation no solve steps are reported (0 on both arms)
        out = dict(grad_accum=k, loss=float(m1["loss"]),
                   loss1=float(m0["loss"]), grad_norm=float(m1["grad_norm"]),
                   grad_norm1=float(m0["grad_norm"]),
                   deq_steps=float(m1.get("deq_steps", 0.0)),
                   deq_steps1=float(m0.get("deq_steps", 0.0)),
                   excess=worst, first_moments=mu, collectives=comms,
                   issued=issued(coll.records), peaks=peaks,
                   seconds_second_step=second)
        if abs(out["loss"] - out["loss1"]) > 2e-2 * abs(out["loss1"]) \
                or worst > 0 or mu["rel_l2"] > MU_REL_L2_SHARDED:
            out["fail"] = True
        del s0
    del p1, mu1
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _local_bytes(tree) -> int:
    """One rank's bytes of a tree's leaves (a DTensor's local shard), each
    storage once, at its 512-byte block."""
    from torch.distributed.tensor import DTensor
    seen = {}
    for t, _ in dryrun.leaves_with_specs(tree):
        st = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
        seen[st.data_ptr()] = -(-st.nbytes() // dryrun.BLOCK) * dryrun.BLOCK
    return sum(seen.values())


def _v2_lite_ep_inputs(base, dev: str):
    """V2-Lite at ``V2_LITE_EP_CAPACITY`` and its 4 x 256 prompt tokens."""
    base = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=V2_LITE_EP_CAPACITY))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        2, base.vocab_size, size=(4, 256)).astype(np.int32)).to(dev)
    return base, toks


def _f32_logits(vcfg, vparams: dict, toks) -> torch.Tensor:
    """The prefill's logits in f32 over ``vparams``'s (bf16) values
    upcast: the answer that a bf16 prefill rounds.  ``vparams`` is emptied
    (moved to the host, then back one leaf at a time as f32), so that the
    card holds the f32 copy alone (V2-Lite: 59 GiB); drop every other
    reference to its leaves first."""
    dev = toks.device
    host = train_steps.tree_map(lambda t: t.cpu(), vparams)
    vparams.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    f32 = train_steps.tree_map(lambda t: t.to(dev, torch.float32), host)
    del host
    out = lm.prefill(f32, {"tokens": toks},
                     dataclasses.replace(vcfg, dtype="float32"),
                     toks.shape[1])[0]
    del f32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _err(got: torch.Tensor, want: torch.Tensor) -> dict:
    return dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                same_argmax=(got.argmax(-1) == want.argmax(-1)).float()
                .mean().item())


def _ep_prefill(vcfg, toks, mesh, rank: int, dev: str,
                floor_mult: float | None) -> dict | None:
    """V2-Lite's prefill at (2, 2) (``PREFILL_RULES``, the EP branch)
    against the unsharded prefill on rank 0: the drops (model rank 0's
    over the data shards), the largest logit error and excess over
    ``TOL_SHARDED``, the argmax agreement.  With ``floor_mult`` (bf16),
    also both arms against an f32 prefill over the same weights.
    ``held``: see ``ep_prefill_held``."""
    import torch.distributed as dist

    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import full_tree
    vparams = lm.init_params(vcfg, seed=0, device=dev)
    pctx = make_ctx(vcfg, mesh, SHAPES["prefill_32k"])
    sharded = lm.place_params(vparams, vcfg, pctx)
    with moe_mod.count_drops() as drops:
        logits = full_tree(lm.prefill(sharded, {"tokens": toks}, vcfg,
                                      toks.shape[1], ctx=pctx)[0])
        mine = int(sum(d.item() for d in drops))
    del sharded
    per_rank = [None] * 4
    dist.all_gather_object(per_rank, (mesh.get_local_rank("model"), mine))
    out = None
    if rank == 0:
        want = lm.prefill(vparams, {"tokens": toks}, vcfg, toks.shape[1])[0]
        exc = excess(logits, want, TOL_SHARDED)
        dropped = sum(n for m, n in per_rank if m == 0)
        out = dict(
            dtype=vcfg.dtype, layers=vcfg.num_layers,
            experts_per_rank=vcfg.moe.num_experts // 2,
            capacity_factor=V2_LITE_EP_CAPACITY, dropped_pairs=dropped,
            **_err(logits, want),
            max_abs_logit=want.float().abs().max().item(),
            tol=TOL_SHARDED, excess=exc, floor_mult=floor_mult)
        if floor_mult is not None:
            truth = _f32_logits(vcfg, vparams, toks)
            out["sharded_vs_f32"] = _err(logits, truth)
            out["unsharded_vs_f32"] = _err(want, truth)
            del truth
        out["held"] = ep_prefill_held(
            dropped, exc, out.get("sharded_vs_f32", {}).get("max_abs_err"),
            out.get("unsharded_vs_f32", {}).get("max_abs_err"), floor_mult)
    del vparams
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def ep_prefill_held(dropped: int, exc: float, err: float | None,
                    floor: float | None, floor_mult: float | None) -> bool:
    """No pair dropped, and the sharded logits within ``TOL_SHARDED`` of
    the unsharded ones (``exc`` <= 0) or, with ``floor_mult``, the sharded
    prefill's largest error against f32 (``err``) within ``floor_mult``
    times the unsharded bf16 prefill's own (``floor``)."""
    return dropped == 0 and (exc <= 0 or (
        floor_mult is not None and err <= floor_mult * floor))


def v2_lite_bf16_error(smi: str) -> dict:
    """On one card, what the four-card EP prefill's bf16 full-depth check
    weighs the sharded arm against: V2-Lite's unsharded bf16 prefill at the
    four-card inputs against an f32 prefill over the same weights."""
    vcfg, toks = _v2_lite_ep_inputs(get_config("deepseek-v2-lite-16b"),
                                    "cuda")
    vparams = lm.init_params(vcfg, seed=0, device="cuda")
    want = lm.prefill(vparams, {"tokens": toks}, vcfg, toks.shape[1])[0]
    truth = _f32_logits(vcfg, vparams, toks)
    res = dict(dtype=vcfg.dtype, layers=vcfg.num_layers,
               unsharded_vs_f32=_err(want, truth),
               max_abs_logit=truth.float().abs().max().item())
    say("sharded_v2_lite_bf16_error", card=smi, **res)
    del vparams, want, truth
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the examples (examples/torch_*.py) through their own functions
# ---------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(ROOT, "examples")
EXAMPLE_QUICK_STEPS = 20
EXAMPLE_TRAIN_STEPS = 3
EXAMPLE_QUICK_RTOL = 1e-4
# the kernels each example's path launches
EXAMPLE_PATHS = {
    "quickstart_full": ("broyden_step", "qn_apply_multi"),
    "quickstart_shine": ("broyden_step", "qn_apply_multi"),
    "quickstart_jfb": ("broyden_step", "qn_apply_multi"),
    "serve_lm": ("flash_attention", "decode_attention", "rmsnorm"),
    "serve_lm_deq": SERVE_PATH,
    "train_deq_lm": TRAIN_PATH,
}


def example_qn_rings() -> list:
    """``(tag, m, B, D)`` of the examples' bf16 qN rings: the quickstart's
    (memory 30 on the M=32 template, 32 samples of 64), the ~100M DEQ
    LM's (memory 10 on M=16, 8 x 256 x 1024) and the smoke DEQ's served
    prompts (its memory, 4 slots, 15 x 64)."""
    serve = smoke_config("stablelm-3b", deq=True)
    return [("quickstart", 30, 32, 64), ("train_deq_lm", 10, 8, 256 * 1024),
            ("serve_lm_deq", serve.deq.memory, 4, 15 * serve.d_model)]


def example_kernel_times(gen) -> dict:
    """The examples' kernels timed at their shapes (their checks against
    the plain versions are ``EXAMPLE_QN``'s cases here and phase 2's
    ``deq_lm_100m`` / ``serve_lm_smoke`` attention cases): both qN ops
    cold (``qn_timing``) at the quickstart's and the ~100M DEQ LM's rings;
    the prefill kernel at the DEQ LM's 8 x 256 x 16 x 64 and the serving
    example's 4 x 15 x 4 x 16, the decode kernel over its 96-token cache,
    each beside the plain version, SDPA and the bound.  Every row in one
    ``kernel`` line."""
    bf = torch.bfloat16
    rows = {}
    for tag, m, bsz, dim in example_qn_rings()[:2]:
        u, v, mask, slot, active, g, s_, hg = qn_case_inputs(m, bsz, dim, bf,
                                                             gen)
        alpha, eps = torch.tensor(1.0, device="cuda"), 1e-8
        ring = 2 * m * bsz * dim * 2
        uu, vv = u.clone(), v.clone()
        shape = f"m={m} B={bsz} D={dim} bf16 ring"
        rows[f"broyden_step[{tag}]"] = qn_timing(
            "broyden_step",
            lambda: cuda_qn.broyden_step(uu, vv, g, s_, hg, alpha, mask,
                                         slot, active, eps),
            lambda: ref.broyden_step_ref(u, v, g, s_, hg, alpha, mask, slot,
                                         active, eps),
            ring + 5 * bsz * dim * 4 + 2 * bsz * dim * 2
            + 2 * bsz * dim * 2, 8 * m * bsz * dim, shape, example=tag)
        xs = g[None]
        rows[f"qn_apply_multi[{tag}]"] = qn_timing(
            "qn_apply_multi",
            lambda: cuda_qn.qn_apply_multi(u, v, xs, alpha, mask, (False,)),
            lambda: ref.qn_apply_multi_ref(u, v, xs, alpha, mask, (False,)),
            ring + 2 * bsz * dim * 4, 4 * m * bsz * dim, shape, example=tag)
    for tag, bsz, seq, h, hd in (("train_deq_lm", 8, 256, 16, 64),
                                 ("serve_lm", 4, 15, 4, 16)):
        q, k, v = _attn_inputs(gen, bsz, seq, seq, h, h, hd, bf)
        kern = lambda: cuda_fa.flash_attention(  # noqa: E731
            q, k, v, causal=True)
        b_ms, b_by = bound(2 * q.numel() * 2 + 2 * k.numel() * 2,
                           4 * bsz * h * hd * seq * (seq + 1) / 2, "bf16")
        rows[f"flash_attention[{tag}]"] = dict(
            shape=f"B={bsz} S=T={seq} H=KV={h} hd={hd} causal bf16",
            ms=time_ms(kern), device_ms=device_ms(kern),
            plain_ms=time_ms(lambda: ref.attention_ref(q, k, v,
                                                       causal=True)),
            library_ms=time_ms(lambda: _sdpa(q, k, v, causal=True)),
            library_device_ms=device_ms(lambda: _sdpa(q, k, v,
                                                      causal=True)),
            bound_ms=b_ms, bound_by=b_by)
    bsz, h, hd, t = 4, 4, 16, 96
    lens = _lens([20, 5, 96, 40])
    q, k, v = _decode_inputs(gen, bsz, h, h, hd, t, bf)
    kern = lambda: cuda_fa.decode_attention(q, k, v, lens)  # noqa: E731
    amask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]
             )[:, None, None, :]
    lib = lambda: _sdpa(q[:, None], k, v, causal=False,  # noqa: E731
                        mask=amask)
    live = int(lens.sum())
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * live * h * hd * 2 + bsz * 4,
                       4 * h * hd * live, "bf16")
    rows["decode_attention[serve_lm]"] = dict(
        shape=f"B={bsz} H=KV={h} hd={hd} T={t} kv_length={lens.tolist()} "
        "bf16", ms=time_ms(kern), device_ms=sum(device_profile(kern)
                                                 .values()),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, k, v, lens)),
        library_ms=time_ms(lib), library_device_ms=device_ms(lib),
        bound_ms=b_ms, bound_by=b_by)
    return rows


@contextlib.contextmanager
def _cpu_threads(n: int):
    """The CPU arm of a parity check on ``n`` intra-op threads (the
    matrix's workers hold the other cores)."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _path_counts(name: str, run):
    """``run()`` with the launch counts set to 0 just before it and read
    just after; fails if a kernel of the example's path did not launch."""
    launches.reset()
    out = run()
    torch.cuda.synchronize()
    counts = launches.counts()
    missing = [k for k in EXAMPLE_PATHS[name] if counts[k] == 0]
    if missing:
        raise AssertionError(f"example {name}: kernels not launched: "
                             f"{missing}")
    return out, counts


def phase_examples(smi: str) -> dict:
    """The three examples on the card through their own functions: the
    quickstart's modes against the same steps on the CPU, the serving
    example as its CLI runs (and in f32 against the CPU), the ~100M DEQ
    LM's first steps; both qN kernels at their rings against the plain
    versions.  Returns each example's launch counts."""
    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    import torch_quickstart as quick
    import torch_serve_lm as serve_ex
    import torch_train_deq_lm as train_ex

    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(26)
    qn_errs = {tag: qn_case(f"example_{tag}", m, b, d, torch.bfloat16, None,
                            gen, straddle=False)
               for tag, m, b, d in example_qn_rings()}
    say("kernel_cases", name="broyden_step, qn_apply_multi (examples)",
        cases={t: f"m={m} B={b} D={d} bf16 ring"
               for t, m, b, d in example_qn_rings()},
        max_abs_err=qn_errs)
    say("example_kernels", card=smi, rows=example_kernel_times(gen))
    counts = {}
    # quickstart: every mode on the card and on the CPU from one draw
    params, x, y = quick.make_problem("cpu")
    card = ({k: v.cuda() for k, v in params.items()}, x.cuda(), y.cuda())
    for mode, label in quick.MODES:
        name = f"quickstart_{mode}"
        (got, secs), counts[name] = _path_counts(name, lambda: quick.train(
            *card, mode, steps=EXAMPLE_QUICK_STEPS, log_every=5))
        with _cpu_threads(1):
            want, _ = quick.train(params, x, y, mode,
                                  steps=EXAMPLE_QUICK_STEPS, log_every=5)
        err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        say("example", name=name, label=label, losses=got, losses_cpu=want,
            max_rel_err=err, seconds=secs, launches=counts[name], card=smi)
        if not all(math.isfinite(v) for v in got) or got[-1] >= got[0] \
                or err > EXAMPLE_QUICK_RTOL:
            raise AssertionError(f"quickstart {mode}: card {got} vs CPU "
                                 f"{want}")
    # serve_lm: as its CLI runs it, then in f32 on the card and the CPU
    for deq in (False, True):
        name = "serve_lm_deq" if deq else "serve_lm"
        t0 = time.perf_counter()
        reqs, counts[name] = _path_counts(
            name, lambda: serve_ex.main(["--deq"] if deq else []))
        cfg = smoke_config("stablelm-3b", deq=deq)
        if any(len(r.out) != 12 or not all(0 <= t < cfg.padded_vocab
                                           for t in r.out) for r in reqs):
            raise AssertionError(f"{name}: outputs {[r.out for r in reqs]}")
        cfg = dataclasses.replace(cfg, dtype="float32")
        if deq:
            cfg = dataclasses.replace(cfg, deq=dataclasses.replace(
                cfg.deq, qn_dtype="float32"))
        cpu_params = lm.init_params(cfg, seed=0, device="cpu")
        toks = {}
        for dev, p in (("cuda", _map(lambda t: t.cuda(), cpu_params)),
                       ("cpu", cpu_params)):
            r = serve_ex.make_requests(cfg.vocab_size, 12)
            with _cpu_threads(1 if dev == "cpu" else torch.get_num_threads()):
                serve_ex.serve(p, cfg, r, slots=4)
            toks[dev] = [q.out for q in r]
        say("example", name=name, requests=len(reqs),
            tokens=sum(len(r.out) for r in reqs),
            f32_tokens_card_eq_cpu=toks["cuda"] == toks["cpu"],
            seconds=time.perf_counter() - t0, launches=counts[name],
            card=smi)
        if toks["cuda"] != toks["cpu"]:
            raise AssertionError(f"{name} f32: card {toks['cuda']} vs CPU "
                                 f"{toks['cpu']}")
    # train_deq_lm: its ~100M config, SHINE, on the card
    ck = tempfile.mkdtemp(prefix="example_ck_")
    t0 = time.perf_counter()
    try:
        state, counts["train_deq_lm"] = _path_counts(
            "train_deq_lm", lambda: train_ex.main(
                ["--steps", str(EXAMPLE_TRAIN_STEPS), "--checkpoint-dir",
                 ck]))
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    finite = all(bool(torch.isfinite(t).all())
                 for t in train_steps.tree_leaves(state.params))
    say("example", name="train_deq_lm", steps=int(state.step),
        params=lm.param_count(train_ex.hundred_m_config(
            "phi3-mini-3.8b", "shine_fallback", True)),
        finite_params=finite, seconds=time.perf_counter() - t0,
        launches=counts["train_deq_lm"], card=smi)
    if int(state.step) != EXAMPLE_TRAIN_STEPS or not finite:
        raise AssertionError("train_deq_lm: the steps did not all land")
    del state
    torch.cuda.empty_cache()
    say("examples_phase", seconds=time.perf_counter() - t_start, card=smi)
    return counts


def timed(smi: str, name: str, fn, *args):
    """``fn(*args)`` with its wall time, to the card's last kernel, in a
    ``phase_time`` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    say("phase_time", phase=name, card=smi,
        seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    matrix = start_dryrun_matrix()
    step_dryrun = start_sharded_dryrun()
    try:
        return _main(matrix, step_dryrun)
    finally:
        for proc, out in (matrix[:2], step_dryrun):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(out, ignore_errors=True)


def _main(matrix: tuple, step_dryrun: tuple) -> int:
    env = phase_env()
    smi = env["nvidia_smi"]
    res = phase_kernels()
    phase_parity()
    phase_train_parity()
    for solver in ("adjoint_broyden", "anderson", "fixed_point"):
        phase_train_parity(solver)
    phase_parity("anderson")
    for arch, _, _ in HEAD_DIM_CONFIGS.values():
        phase_parity(arch=arch)
        phase_train_parity(arch=arch)
    drains = phase_serve_configs(smi)
    serve_counts, n_solves, params, cfg = phase_serve(smi)
    prefix_counts = phase_serve_prefix(params, cfg, smi)
    timed(smi, "chaos", phase_chaos, params, cfg, smi)
    phase_profile(params, cfg, smi)
    train_counts = phase_train(params, cfg, smi)
    phase_refine_carry(params, cfg, smi)
    phase_skip_carry(params, cfg, smi)
    solver_counts = phase_train_solvers(params, cfg, smi)
    del params
    torch.cuda.empty_cache()
    mdeq_counts = timed(smi, "mdeq", phase_mdeq, smi)
    timed(smi, "bilevel", phase_bilevel, smi)
    torch.cuda.empty_cache()
    moe = timed(smi, "moe", phase_moe, smi)
    moe_counts = moe["drain"]["counts"]
    torch.cuda.empty_cache()
    hybrid = timed(smi, "hybrid", phase_hybrid, smi)
    torch.cuda.empty_cache()
    xlstm = timed(smi, "xlstm", phase_xlstm, smi)
    torch.cuda.empty_cache()
    stack = timed(smi, "train_stack", phase_train_stack, smi)
    torch.cuda.empty_cache()
    av = timed(smi, "audio_vlm", phase_audio_vlm, smi)
    torch.cuda.empty_cache()
    sharded = timed(smi, "sharded", phase_sharded, smi, step_dryrun)
    torch.cuda.empty_cache()
    examples = timed(smi, "examples", phase_examples, smi)
    torch.cuda.empty_cache()
    # last: the matrix, started with the script, runs beside every phase
    timed(smi, "layout", phase_layout, matrix, smi)
    rows = []
    for name, (route, source, replaces) in KERNELS.items():
        r = res[name]
        row = {"name": name, "route": route, "source": source,
               "replaces": replaces,
               "launches": (serve_counts[name] + prefix_counts[name]
                            + train_counts[name]
                            + mdeq_counts["sgd"][name] + moe_counts[name]
                            + hybrid["drain"]["counts"][name]
                            + hybrid["train"][name]
                            + xlstm["drain"]["counts"][name]
                            + xlstm["train"][name]
                            + sum(c[name] for c in av.values())
                            + sharded["counts"].get(name, 0)
                            + sum(c[name] for c in examples.values())),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"],
               "library_ms": r.get("library_ms"),
               "library_device_ms": r.get("library_device_ms"),
               "device_ms": r["device_ms"], "shape": r["shape"],
               **{k: r[k] for k in ("device_ms_warm",
                                    "library_device_ms_warm") if k in r},
               "launches_serve": serve_counts[name],
               "launches_serve_prefix_async": prefix_counts[name],
               "launches_per_serve_solve": serve_counts[name] / n_solves,
               "launches_train": train_counts[name],
               "launches_per_train_step": train_counts[name] / 4,
               **{f"launches_train_{solver}": c[name]
                  for solver, c in solver_counts.items()},
               "launches_mdeq_forward": mdeq_counts["forward"][name],
               "launches_mdeq_sgd": mdeq_counts["sgd"][name],
               "launches_per_mdeq_sgd_step": (mdeq_counts["sgd"][name]
                                              / MDEQ_SGD_STEPS),
               "launches_moe_serve": moe_counts[name],
               "launches_moe_deq_serve": moe["deq_counts"][name],
               "launches_moe_per_prefill": moe["cache"][
                   "launches_per_prefill"].get(name, 0),
               "launches_moe_per_decode": moe["cache"][
                   "launches_per_decode"].get(name, 0),
               "launches_hybrid_serve": hybrid["drain"]["counts"][name],
               "launches_hybrid_train": hybrid["train"][name],
               "launches_hybrid_per_train_step": (hybrid["train"][name]
                                                  / HYBRID_TRAIN["steps"]),
               "launches_hybrid_deq_serve": hybrid["deq_counts"][name],
               **{f"launches_hybrid_per_{k}_s{seq}": c[
                   f"launches_per_{k}"].get(name, 0)
                  for seq, c in hybrid["cache"].items()
                  for k in ("prefill", "decode")},
               "launches_xlstm_serve": xlstm["drain"]["counts"][name],
               "launches_xlstm_train": xlstm["train"][name],
               "launches_xlstm_per_train_step": (xlstm["train"][name]
                                                 / XLSTM_TRAIN["steps"]),
               "launches_xlstm_deq_serve": xlstm["deq_counts"][name],
               **{f"launches_xlstm_per_{k}_s{seq}": c[
                   f"launches_per_{k}"].get(name, 0)
                  for seq, c in xlstm["cache"].items()
                  for k in ("prefill", "decode")},
               "launches_train_stack_v2_lite_remat_full": stack["counts"][
                   name],
               "launches_audio_train": av["audio_train"][name],
               "launches_audio_per_train_step": (av["audio_train"][name]
                                                 / AUDIO_TRAIN["steps"]),
               "launches_audio_deq_train": av["audio_deq_train"][name],
               "launches_audio_deq_per_train_step": (
                   av["audio_deq_train"][name] / AUDIO_DEQ_TRAIN["steps"]),
               "launches_vlm_serve": av["vlm_drain"][name],
               "launches_vlm_train": av["vlm_train"][name],
               "launches_sharded_1x1": sharded["counts"].get(name, 0),
               **{f"launches_example_{k}": c[name]
                  for k, c in examples.items()},
               **({"max_abs_err_2x2_local": sharded["errs"][name]}
                  if name in sharded["errs"] else {}),
               **{k: r[k] for k in ("launches_per_call", "decode_ms",
                                    "decode_device_ms", "decode_bound_ms",
                                    "decode_launches_per_call",
                                    "composition_device_ms") if k in r},
               **{k: v for k, v in r.items()
                  if k.startswith(("adjoint_", "mdeq_"))},
               **{k: r[k] for k in ("head_dims", "shapes") if k in r}}
        if name in OFF_PATH:
            if row["launches"]:
                raise AssertionError(f"{name} launched on a path")
            row["note"] = ("no path of either package launches it (only "
                           "the ops and LowRank methods); checked in "
                           "phase 2")
        rows.append(row)
    say("serve_configs", drains={k: {f: v[f] for f in (
        "head_dim", "tokens", "tok_per_s", "peak_mem_gib")}
        for k, v in drains.items()})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
