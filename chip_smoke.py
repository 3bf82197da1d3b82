#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA libraries (matmul, flash_attention, paged_attention,
     reduction, stencil, rmsnorm; one nvcc each, all at once, sm_90a);
     ptxas's registers and spills (by kernel and template arguments for
     every library but the matmul, with any wgmma serialisation notice);
  3. each kernel against its plain PyTorch version on the card, element by
     element, at the llama3-8b serving shapes, in bf16 and f32 (the matmul
     at every main-path M, 1 to 512, at mixtral's expert buffer rows 2, 11,
     70 and 1,440, and at ragged shapes; flash attention at every
     whole-prompt length of the paths, ragged ones, B = 2, windows across
     tile edges, mixtral's window of 4,096 at 4,608 tokens (twice for the
     same bits), every head dim causal and not, and
     phi3-mini's heads (32 over 32 of 96) at S = 512, twice for the same
     bits (bf16 must take wgmma, f32 tf32x3: three TF32 products, at head
     dims 64, 96 and 128; simt at 16 and 32); the matmul at mamba2-370m's
     ``in_proj`` (N = 4,384, its 32-column edge tile read alone too) and
     ``out_proj`` (K = 2,048) at M = 4, 223 and 4,096, rmsnorm at D = 1,024
     and 2,048, mixtral's expert products at its train step's C = 1,280
     buffer rows and at C = 1,283, and flash attention at mixtral's train
     shape (4, 32/8, 1024, 128, window 4,096) (``_family_checks``); the
     cross-attention families' shapes (``_xattn_checks``: flash attention
     forward and backward, non-causal, at ``kernel_checks.XATTN_FLASH_CASES``,
     Sk = 6,404 against S = 35 to 1,024, Sk = 256 against 1,024, the
     encoder's S = Sk = 256 and 200, ragged Sk of 1, 63, 65 and 300, bf16 at
     D = 64 and 128 on wgmma both ways; the matmul at llama-3.2-vision's
     context K/V projection (M = 25,616) and seamless's projections and MLP
     at 4 to 4,096 rows, forward, dX and dW; rmsnorm at D = 1,024); paged
     attention at ``PAGED_LENS`` and at ``kernel_checks.PAGED_CASES``
     (split and one-slice plans, slice edges, empty sequences, a 128-row
     chunk on one table, the smoke heads, G = 8), called twice for the same
     bits; each line naming the kernel variant or plan it took);
  3c. the backward kernels against their plain versions (the gradient
     formulas of ``kernels/ref.py``), element by element, each called twice
     for the same bits: rmsnorm's dx and dgamma at (4096, 4096) and ragged
     rows, the matmul's dA and dB at each llama3-8b projection over 4096
     tokens and at ragged shapes, flash attention's dq, dk, dv at (4, 32/8
     heads, S = 1024, D = 128) causal, ragged and windowed, at D = 64 and
     the training length, at every head dim (``kernel_checks.*_BWD_*``),
     at phi3-mini's train step (4, 32/32, 1024, 96) and mixtral's (window
     4,096), the matmul's dA and dB at mamba2-370m's projections over 4,096
     tokens and at mixtral's expert products at C = 1,280 and 1,283 (dB
     through simt there), rmsnorm's at D = 1,024 and 2,048, in bf16 and
     f32; each
     line naming the kernels taken (flash attention's ``bwd_variant``: bf16
     at the llama3-8b and phi3-mini heads must take wgmma, f32 tf32x3;
     rmsnorm's ``bwd_path``); then head dim 96 in bf16 forward and
     backward at ``kernel_checks.D96_CASES`` (phi3-mini's train step,
     ragged prompts, a window, GQA 32/8), from the model's (B, S, H, D)
     views and (B, H, S, D)
     tensors, into outputs with NaN guard columns after each row that no
     store may touch (``check_flash_d96``);
  3b. the paper's Table I kernels (dotprod, expv, softmax_rows, jacobi2d,
     fconv2d) against their plain versions at the table1-paper and
     table1-card shapes and at ragged ones (softmax also on masked rows,
     each line naming the branch of ``reduction.softmax_plan`` it took),
     in f32 and bf16; fconv2d also at every filter side 1 to 16, square and
     not, unrolled and generic, from aligned and unaligned bases
     (``kernel_checks.CONV_FILTERS``; each line naming ``conv_plan``'s
     choice); dotprod and dotprod_hier against an f64 sum, with
     dots that round to bf16 as controls that must fail the same check;
     expv on every f32 bit pattern (2**32, in chunks of 2**28), every bf16
     one and the round-half edges of its range reduction, the bits that
     differ counted (``kernel_checks.sweep_expv``);
  4. the llama3-8b smoke model (f32, seeded weights): logits and greedy
     token streams of the kernel path on the card against the plain path
     on the CPU, for the dense engine and the paged engine (whole-prompt,
     chunked, and two pods behind the router), paged == dense;
  4b. the smoke models' training (f32, the JAX initialiser's weights from
     ``testing/<arch>-smoke-jax-seed0.npz``: llama3-8b, mixtral-8x7b,
     qwen3-moe, mamba2-370m, jamba, seamless-m4t-large-v2 and
     llama-3.2-vision-11b, the last two with the train launcher's
     contexts): the loss and every gradient leaf,
     then two ``make_train_step`` steps, on the card through the kernels
     against the CPU's plain path (``testing/train_checks.py``'s limits;
     jamba held at its start);
  5. the dense path: llama3-8b at full width and full depth (bf16, seeded
     random weights) serving 8 requests through ``ServingEngine``, with
     the kernels' launch counts checked per forward; then profiler traces
     of a few decode steps and of two whole-prompt prefills (device time per
     kernel, the device's idle share); then the mamba2-370m and jamba smoke
     models (f32) card against CPU, logits and the dense engine's streams;
  5c. the paged path: the same weights through ``PagedServingEngine``,
     whole-prompt and with 128-token chunked prefill, each under
     ``traffic.run_open_loop`` (16 requests, Poisson arrivals, a Zipf pool
     of 8 synthetic prompts of 64-512 tokens), with launch counts checked
     per forward, the zero block checked and ``shutdown()`` passing; then a
     trace of four paged decode steps at batch 8;
  5e. the Table I path: each Table I workload once through ``ops`` at both
     configurations (f32), outputs held against the plain versions, launch
     counts checked;
  7. the training path: llama3-8b at full width and 8 of its 32 layers
     (bf16, seeded random weights, remat on, ``OptConfig`` defaults), 3
     steps of ``make_train_step`` at batch 4 x 1024 tokens from
     ``SyntheticCorpus``: finite losses, the launch counts of every kernel
     forward and backward exactly ``trainer.step_launches``' formula, step
     ms, tok/s and peak memory, a profiler trace of one step beside the
     step's bound, the embedding's gradient taken twice for the same bits,
     and one more step split into its gradient and its update;
  7b. phi3-mini-3.8b at its published width (head dim 96: the wgmma flash
     kernels) cut to 2 of its 32 layers (bf16, seeded random weights): a
     512-token whole-prompt prefill and decode steps through
     ``ServingEngine``, then a cold and a warm train step at batch 4 x 1024
     tokens (host clock), each with a finite loss and launch counts exactly
     ``trainer.step_launches``, and a profiler trace of a later step (the
     flash forward's and backward's device ms a step);
  8. the MoE family: the qwen3-moe and mixtral smoke models (f32) card
     against CPU (logits and dense streams; qwen3-moe also paged,
     whole-prompt, 128-token chunks and two pods), then mixtral-8x7b at its
     published width cut to 24 of its 32 layers (bf16, seeded weights, the
     earlier phases' models freed first) serving 8 requests through
     ``ServingEngine`` at batch 4 (one prompt of 4,608 tokens, past the
     4,096-token window, and seven of phase 5's), launch counts exactly
     ``trainer.serve_launches``; traces of decode steps and of 223- and
     4,608-token prefills (the windowed flash kernel launched a layer),
     each split by sublayer (the MoE sublayers' expert products and their
     plain-torch router and dispatch apart);
     and one full-width MoE sublayer (a 223-token prefill, a batch-4 decode
     step) held to the CPU path on the same bf16 weights and input: output
     within the bf16 matmul limits, routing equal but for ties within
     rounding, dropped pairs of both sides printed; then mixtral-8x7b's
     training at its published width cut to 2 of 32 layers (the serving
     model freed first): 3 steps at batch 4 x 1024 under remat (C = 1,280
     rows an expert, phase 7's ``OptConfig`` defaults), launches exactly
     ``trainer.step_launches``, step ms, tok/s, peak memory, a traced step
     split forward and backward by sublayer (``_split``), and one
     full-width MoE sublayer's gradients (x, router, the busiest expert's
     wi, wg, wo) held to the CPU path at 128 tokens, routing equal, the
     card's the same bits twice;
  9. the Mamba2 family: mamba2-370m at its published width and depth (48
     layers, bf16, seeded weights) serving 8 requests through
     ``ServingEngine`` at batch 4 (one prompt of 4,608 tokens, 18 SSD
     chunks, and seven of phase 5's), launches exactly
     ``trainer.serve_launches``; traces of decode steps and of 223- and
     4,608-token prefills split by kernel class (products, norms, the
     plain-torch SSD and conv); one full-width Mamba sublayer held to the
     CPU path at both prefills and a batch-4 decode step, output, conv
     window and SSM state (``kernel_checks.mamba_tol``); then 3 train steps
     at batch 4 x 1024 under remat, launches exactly ``step_launches``, the
     loss falling, step ms, tok/s, peak memory and a traced step;
 10. the cross-attention families (``_xattn_path``): the seamless and
     llama-3.2-vision smoke models (f32, the JAX init) card against CPU,
     ``prefill(ctx_embeds)`` then decode logits and greedy streams;
     llama-3.2-vision-11b at its published width and all 40 layers (bf16,
     seeded weights) serving through ``lm.prefill``/``lm.decode_step`` (no
     engine takes a context, as the reference's does not): 4 prompts of 512
     tokens each with its 6,404 image tokens, 32 greedy tokens, then a
     batch-4 prefill of 223 tokens, launches exactly
     ``trainer.serve_launches``, traces of decode steps and of the prefill
     split by sublayer (``_xsplit``), one full-width cross-attention
     sublayer (prefill and decode step) held to the CPU path
     (``kernel_checks.xattn_tol``); seamless-m4t-large-v2 whole (24
     decoder and 24 encoder layers) the same way with 256 frames a
     1,024-token prompt; seamless training whole and llama-3.2-vision
     training at 2 of its 8 periods (3 steps at 4 x 1,024 with the train
     launcher's contexts, launches exactly ``step_launches``, traced steps,
     the cross-attention sublayer and the encoder timed apart), and one
     full-width cross-attention sublayer's gradients (x, ctx, wq, wk, wv,
     wo) held to the CPU path at 128 tokens against 6,404 context tokens;
 11. state and resilience (``_state_path``): (a) llama3-8b at its
     published width cut to 2 of its 32 layers (bf16, seeded weights,
     remat; the free bytes under ``build/state_ckpt`` printed first, and
     fewer than three checkpoints' worth fail the phase) through
     ``launch.train.run`` with checkpoints: 4 steps at 4 x 1024, saved at
     steps 2 and 4; step 4's leaf crc32s recorded and the directory
     deleted; a resumed run must restore step 2, give steps 2-3's losses
     bit for bit and rewrite step 4 with the same crc32 on every leaf;
     step 4 torn, ``latest_step`` must be 2; launches exactly
     ``step_launches`` a step; printed: how long ``save_async`` holds the
     step loop, the writer's GB/s, restore ms and GB/s, step ms with a save
     in flight and without, peak device and host memory; (b)
     ``testing.check_chaos.main`` (smoke model, 12 steps, a kill, a
     straggler, a torn checkpoint) on the card, its fingerprints, restarts
     and timeline equal to the CPU run's and its losses within
     ``train_checks.SCALAR_RTOL``; (c) ``testing.check_chaos_procs.main``
     with the primary worker on the card (real SIGKILLs, one of the
     primary mid-save; the failover primary takes the card), its detection
     latencies printed;
 12. distributed compute (``_dist_path``; ``--only dist``): four ranks
     share the card (``parallel.comm.layout``: gloo, every CUDA tensor a
     collective sends copied through a host buffer; NCCL refuses two
     ranks of one communicator on one card), each rank a
     ``python -m repro_torch.testing.check_dist_*`` process started by
     ``testing.subproc.run_ranks`` after the one-process run it is held
     to: (a) llama3-8b at its published width, 2 of 32 layers, on a
     (2, 2) mesh, 3 steps at 4 x 1024 under remat (ZeRO-3 over `data`,
     tensor-parallel over `model`, vocab-parallel loss): losses and grad
     norms within ``DIST_LOSS_RTOL`` and ``DIST_GNORM_RTOL`` of one
     process, samples of 9 leaves' step-1 gradients within
     ``DIST_GRAD_RTOL``, each rank's launches a step exactly
     ``step_launches``; (b) one MoE sublayer at
     its published width on (1, 4): qwen3-moe in ep and ep_a2a, mixtral
     in tp, within ``kernel_checks.moe_tol``, the 2 x 2 hierarchical
     all-to-all bit-equal to the flat one; (c) llama3-8b, 2 layers,
     decoding 16 steps over a 4,096-slot cache cut over `model` after a
     512-token prefill at batch 4, logits within ``DIST_LOGIT_SHARE`` of
     one process, the greedy tokens' agreement printed; (d) ring
     attention at (1, 16384, 32/8, 128) bf16, flat (seq and db) and 2 x 2
     hierarchical, causal and window 4,096, within ``ATTN_TOL[bf16]`` of
     the flash kernel, db bit-equal to seq; every rank's host ms, ms
     inside collectives, bytes sent and peak memory printed beside the
     card's name and power limit (a shared card through the host, not
     NCCL over NVLink);
 13. state and serving on a mesh (``_mesh_path``; ``--only mesh``): eight
     ranks share the card as phase 12's four do: (a) llama3-8b at its
     published width, 2 of 32 layers (the weights whole over (pod, data):
     ZeRO-3 would copy every layer through the host at every step), on a
     (2, 2, 2) (pod, data, model) mesh, the dense engine blind and
     topology-aware and the paged engine whole and chunked and behind the
     router (``testing.check_serve_topology`` / ``check_serve_paged
     --size full``: batch 4, prompts of 64-512 tokens, 16 new tokens),
     every assertion of the CPU checks but the streams between engines,
     which are measured; each rank's launches exactly ``serve_launches``;
     every engine's logits within ``DIST_LOGIT_SHARE`` of the same engine
     in one process on the card, the greedy agreement printed; (b)
     mamba2-370m's Mamba2 sublayer and (c) llama-3.2-vision-11b's
     cross-attention sublayer (6,404 context tokens) at their published
     widths on (1, 4), prefill and decode within
     ``kernel_checks.mamba_tol`` / ``xattn_tol`` of one process; (d)
     ``testing.check_chaos --mesh`` (8 ranks, (4, 2) -> (2, 2)) on the card
     against the same on the CPU; (e) ``testing.check_ckpt_mesh``: a (2,
     2) save restored onto (1, 2), every leaf's crc32 equal; each rank's
     host ms a decode step, ms inside collectives, bytes sent, peak memory
     and TTFT printed beside the card's name and power limit;
 14. the paper's machine (``_machine_path``; ``--only machine``; no
     library is built, no kernel of the port launches): the AraXL emulator
     of ``repro_torch.core`` in f64 at VLEN 64 Kibit (VLMAX 1,024); (a) a
     one-lane machine in this process on the card and on the CPU, every
     instruction (``testing.check_core.exercise``) and the six Table I
     programs at a register's sizes (fmatmul (8, 64) @ (64, 1024), fconv2d
     7 x 7 over (16, 1024), jacobi2d (16, 1024), fdotproduct and exp on
     2**16, softmax (8, 1024)), each against numpy and the card against the
     CPU; (b) ``testing.check_core`` on eight ranks sharing the card: the
     (2, 4), (4, 2) and (2, 2, 2) machines under the reference's five
     configurations, ``check_topology``'s machines and
     ``check_collectives``' reductions, all-gathers and reduce-scatters;
     (c) sixteen ranks,
     the (4, 4) AraXL-16, two-level, staged, ring: the GLSU round trip at
     VLMAX, slides, both reductions, fdotproduct on 2**14 elements and
     softmax on (4, 1024); (b) and (c) also on CPU ranks, every output of
     the card's ranks bit-equal to theirs but the sums (1e-12) and exp
     (1e-14), the same bits on every rank; each part's host ms an
     instruction by unit, ms inside collectives, bytes sent and peak
     memory a rank, beside the cycle model's cycles and FPU utilisation
     for the same programs at that lane count (a functional run: lanes
     sharing one card through host buffers say nothing of the machine's
     speed);
 15. the tooling (``_tooling_path``; ``--only tooling``): (a) the
     autotuner (``kernels.autotune``) at its ``CASES`` (llama3-8b's
     projections at every main-path M and the backward's products at
     prefill M, two prefills' attention, the batch-8 paged step, the
     decode step's rmsnorm, the Table I sizes), top-k 3 with every
     candidate measured, into ``build/autotune/cache.json``: each signature's candidates (model and
     measured us, each measured one held to its plain version within
     ``kernel_checks``' limits), the winner and the model's agreement; the
     wgmma step and split costs the measured split counts fit beside the
     hand-set ``WGMMA_STEP_US``/``WGMMA_SPLIT_US``; (b) llama3-8b at full
     width and depth, phase 5's workload through the dense engine untuned
     and twice under the table (the same bits twice, launches exactly
     ``serve_launches``, decode ms a step beside the untuned run's, a
     traced untuned decode step); (c) the dry run (``launch.dryrun``) of
     llama3-8b's decode and train cells at the one-card geometry beside
     the measured peaks and the traced busy ms, and the production cell
     train_4k on pod16x16 (256 ranks of torch's fake process group, on the
     host); (d) ``examples.serve_batch`` on the card, its streams equal to
     the CPU's;
  6. kernel times (CUDA events) beside the plain version, the one PyTorch
     call that computes the same function, and the card's bound (rmsnorm at
     every main-path R in both dtypes, with its device ms a call beside
     F.rms_norm's and its host cost a call in turns; the matmul at every
     main-path M in both dtypes, and each matmul variant's host cost a call
     at K = N = 64; flash attention at S = 37, 223, 445 and 512 with the
     device's ms a call beside SDPA's, phi3-mini's heads at S = 512 the same
     way and through the simt kernel, forced, each port kernel the mean of
     the kernels so named in a trace, and each variant's host cost a call;
     paged attention at the traced batch-8
     decode step's inputs with its device ms a call from a trace, its plan,
     and its host cost a call alone), the Table I kernels at both
     configurations (at table1-paper also their device time and the
     library call's from profiler traces, fconv2d's at table1-card too,
     and each one's host cost a call in turns with torch.dot, torch.exp,
     torch.softmax or F.conv2d); the backward kernels at the training
     shapes (rmsnorm's at (4096, 4096), the matmul's two products at each
     projection, each product's device ms beside torch.matmul's and the
     forward's at M = 4,096 beside it, flash attention's at (4, 32/8, 1024,
     128) and phi3-mini's (4, 32/32, 1024, 96), the latter's the mean of
     each of its two kernels in a trace, its simt kernels' too) beside their
     plain versions, the library call (autograd of ``F.rms_norm``,
     ``torch.matmul`` for each product, autograd of SDPA), the bound, and
     the device's ms a call from a trace, each naming its kernels (flash
     attention's also through the simt kernels, forced, for the same call);
     flash attention non-causal at the cross-attention families' shapes
     (``XATTN_TIMED``), forward and backward, beside SDPA and autograd of
     SDPA with the kv heads expanded; the f32 rows of the kernel table
     (``_f32_rows``: 3b, flash attention's forward at (1, 32/8, 512, 128);
     3h, its backward at (4, 32/8, 1024, 128), the dq and dkv grids apart;
     2d, the f32 matmul at (333, 4096) @ (4096, 14336)), each checked
     first, beside the simt kernels forced in the same run, SDPA and
     autograd of SDPA with the kv heads expanded (and with ``enable_gqa``,
     which takes the math path in f32; each naming the backend that ran
     by its kernels) or ``torch.matmul`` in full f32, and the bound at f32
     accuracy both ways:
     three TF32 products on the tensor cores and the CUDA cores.
The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  ``--only PART`` runs one part alone
(``ONLY``: ``matmul-bwd``, phase 6's matmul backward rows; ``phi3``, phase
7b and phase 6's phi3-mini flash rows; ``moe``, phase 8's serving;
``moe-train``, phase 8's training; ``ssm``, phase 5's Mamba smoke models
and phase 9; ``xattn``, phases 3 and 3c's cross-attention checks, phase 10
and phase 6's cross-attention rows; ``f32``, phase 6's f32 rows and the
flash libraries' ptxas lines; ``state``, phase 11; ``dist``, phase
12; ``mesh``, phase 13; ``machine``, phase 14; ``tooling``, phase 15), so that a copy
of this file at another checkout's root reads that tree's kernels with
this file's readings.  Imports nothing of JAX.  Without a
card, or without the repo's ``src/repro_torch`` beside it, it exits
non-zero before any phase (2 and 1).
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# operations/s by type (bf16 on the tensor cores, f32 on the CUDA cores, and
# f32-accurate work as three TF32 products at the dense TF32 rate)
HBM_BYTES_S = 3.35e12
CUDA_LIBS = ("matmul", "flash_attention", "flash_attention_bwd",
             "paged_attention", "reduction", "stencil", "rmsnorm")
# open-loop arrival rate of the paged serve phase (requests / second)
PAGED_RATE = 1.5
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12, "tf32x3": 494.7e12 / 3}


def _ms_bound(nbytes: float, nops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, nops / PEAK_OPS_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the device-side name of each port kernel, as the profiler shows it (the
# matmul and flash attention by variant: kernels.matmul.variant,
# kernels.flash_attention.variant; the first tag a name holds wins, so the
# stats backward's instances of the wgmma kernels, <true, D>, come first)
# (names without spaces: the profiler's are compared with theirs taken out;
# the backward's matmul products are matmul_bwd_kernel's two forms)
PORT_KERNELS = {"matmul_bwd dX wgmma": "matmul_bwd_kernel<0,0>",
                "matmul_bwd dW wgmma": "matmul_bwd_kernel<1,1>",
                "rmsnorm_bwd vec": "rms_bwd_vec_kernel",
                "rmsnorm_bwd scalar": "rms_bwd_kernel",
                "rmsnorm_bwd dgamma": "rms_dgamma_kernel",
                "flash_attention_bwd dd stats": "flash_bwd_dd_kernel",
                "flash_attention_bwd dq stats": "flash_bwd_dq_wgmma_kernel<true",
                "flash_attention_bwd dkv stats": "flash_bwd_dkv_wgmma_kernel<true",
                "flash_attention_bwd dq wgmma": "flash_bwd_dq_wgmma_kernel",
                "flash_attention_bwd dkv wgmma": "flash_bwd_dkv_wgmma_kernel",
                "flash_attention_bwd dq tf32x3": "flash_bwd_dq_tf32_kernel",
                "flash_attention_bwd dkv tf32x3": "flash_bwd_dkv_tf32_kernel",
                "flash_attention_bwd dq simt": "flash_bwd_dq_kernel",
                "flash_attention_bwd dkv simt": "flash_bwd_dkv_kernel",
                "matmul decode": "matmul_decode_kernel",
                "matmul wgmma": "matmul_wgmma_kernel",
                "matmul simt": "matmul_kernel", "rmsnorm": "rms_vec_kernel",
                "rmsnorm scalar": "rms_scalar_kernel",
                "flash_attention wgmma": "flash_wgmma_kernel",
                "flash_attention tf32x3 split": "flash_tf32_split_kernel",
                "flash_attention tf32x3": "flash_tf32_kernel",
                "flash_attention simt": "flash_kernel",
                "paged_attention": "paged_kernel",
                "softmax_rows regs": "softmax_regs_kernel",
                "softmax_rows stream": "softmax_stream_kernel"}


def _reading(r: dict) -> str:
    """One element-wise check (``testing.kernel_checks``): the largest error,
    the same over the output's scale, and the largest share of its limit."""
    return (f"max_abs_err={r['max_abs_err']:.3e} rel_to_scale={r['rel_err']:.2e} "
            f"limit_use={r['limit_use']:.3f} (|err| <= {r['rtol']:.0e}|plain| + "
            f"{r['atol']:.0e}) {'ok' if r['ok'] else 'FAIL'}")


def _trace(step, steps: int) -> dict:
    """Device time of ``steps`` calls of ``step`` (a decode step, or a
    prefill that ends on a host read) from a torch.profiler trace of the
    card's activity only (no host-op recording): time per kernel family,
    and the busy time, the union of the kernels' intervals.  The profiler
    still slows the host's launches, so twice as many steps are first timed
    without it; the idle share is read against their mean.  Times are per
    step; ``seq`` is every kernel's family and us in launch order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.testing.timing import now

    torch.cuda.synchronize()
    t0 = now()
    for _ in range(2 * steps):
        step()
    plain_us = 1e6 * (now() - t0) / (2 * steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(steps):
            step()                       # ends on a host read
        wall_us = 1e6 * (now() - t0) / steps
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy, end = 0.0, -1.0
    by, seq = {}, []
    for e in evs:
        s, f = e.time_range.start, e.time_range.end
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
        bare = e.name.replace(" ", "")
        fam = next((f"{k} (port)" for k, tag in PORT_KERNELS.items()
                    if tag in bare), e.name)
        n, t = by.get(fam, (0, 0.0))
        by[fam] = (n + 1 / steps, t + (f - s) / steps)
        seq.append((fam, f - s))
    return {"events": len(evs), "wall_us": wall_us, "plain_us": plain_us,
            "busy_us": busy / steps, "seq": seq,
            "by": sorted(by.items(), key=lambda kv: -kv[1][1])}


def _ptxas_summary(log: str) -> list:
    """nvcc's ``-Xptxas -v`` lines, one a kernel: its name (template
    arguments kept: dtype, then the integers (a head dim, a filter's sides,
    stages) and vec or scalar loads), registers,
    spills, static shared memory, and any ptxas performance notice (C75xx)
    beside it."""
    import re

    def nested(sym: str) -> tuple[str, str]:
        """The last name of a mangled nested name (_ZN, then names each
        after its length: the namespace's, the kernel's) and what follows."""
        pos, last = 3, ""
        while pos < len(sym) and sym[pos].isdigit():
            end = pos
            while sym[end].isdigit():
                end += 1
            n = int(sym[pos:end])
            last, pos = sym[end:end + n], end + n
        return last, sym[pos:]

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_ZN\w+)", line)
        kernel, rest = nested(m.group(1)) if m else ("", "")
        t = re.match(r"I(\w+?)E+v", rest)
        if kernel.endswith("kernel") and t:
            args = re.sub(r"Li(\d+)E?", r" \1", t.group(1).replace("13__nv_bfloat16", "bf16")
                          .replace("Lb1E", " vec ").replace("Lb0E", " scalar ")
                          .replace("Lb1", " vec").replace("Lb0", " scalar"))
            if args.startswith("f"):
                args = "f32" + args[1:]
            name = f"{kernel}<{', '.join(args.split())}>"
        if name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.replace('ptxas info    :', '').strip()}")
        if "C75" in line:
            out.append(line.strip()[:160])
    return out


def _check_pool(engine) -> None:
    """Every block back, the prefix registry empty (``shutdown``), and the
    zero block still zero in every layer."""
    from repro_torch.params import tree_leaves

    engine.shutdown()
    for leaf in tree_leaves(engine.pool):
        if bool(leaf[:, 0].any()):
            raise AssertionError("the zero block was written")


def _print_trace(tr: dict, steps: int, what: str) -> None:
    if not tr["events"]:
        print("[trace] the profiler recorded no device activity: device time "
              "per kernel and idle share not measured")
        return
    print(f"[trace] {steps} {what}: "
          f"{tr['plain_us'] / 1e3:.2f} ms/step host clock over {2 * steps} "
          f"unprofiled steps, {tr['wall_us'] / 1e3:.2f} ms/step under the "
          f"profiler; device busy {tr['busy_us'] / 1e3:.2f} ms/step; idle "
          f"share {1 - tr['busy_us'] / tr['plain_us']:.3f} of the unprofiled "
          f"steps ({1 - tr['busy_us'] / tr['wall_us']:.3f} of the profiled)")
    port = [kv for kv in tr["by"] if kv[0].endswith("(port)")]
    other = [kv for kv in tr["by"] if not kv[0].endswith("(port)")]
    rest = (sum(n for _, (n, _) in other[6:]), sum(t for _, (_, t) in other[6:]))
    for fam, (n, t) in port + other[:6] + [
            (f"{len(other[6:])} other kernels", rest)]:
        print(f"[trace]   {t / 1e3:8.3f} ms/step  {n:6.1f} launches/step  "
              f"{fam[:90]}")


def _smoke_dense(scfg, cpu_params, gpu_params, dev) -> None:
    """A smoke model (f32) through the kernel path on the card and the
    plain path on the CPU: a 21-token prefill of two rows and 8 decode
    steps, logits within 1e-4 (the paths differ only in f32 summation
    order, which moves logits of order 1 by ~1e-6 a layer), then the
    dense engine's greedy streams, 5 requests through 2 slots, equal."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, scfg.vocab_size, (2, 21)))
    c_cpu, l_cpu = lm.prefill(cpu_params, toks, scfg, 64)
    c_gpu, l_gpu = lm.prefill(gpu_params, toks.to(dev), scfg, 64)
    worst = (l_gpu.cpu() - l_cpu).abs().max().item()
    for step in range(8):
        nxt = torch.argmax(l_cpu[:, -1], dim=-1, keepdim=True)
        pos = torch.tensor([21 + step, 21 + step])
        l_cpu, c_cpu = lm.decode_step(cpu_params, nxt, c_cpu, pos, scfg)
        l_gpu, c_gpu = lm.decode_step(gpu_params, nxt.to(dev), c_gpu, pos.to(dev),
                                      scfg)
        worst = max(worst, (l_gpu.cpu() - l_cpu).abs().max().item())
    print(f"[smoke] {scfg.name} f32 prefill+8 decode logits, card vs CPU: "
          f"max_abs_err={worst:.3e} (tol 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"{scfg.name} logits differ by {worst}")
    streams = {}
    for where, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = ServingEngine(lm.Model(scfg, params), ServeConfig(max_batch=2, max_seq=64),
                            device=dev if where == "cuda" else "cpu")
        prng = np.random.default_rng(1)
        for rid in range(5):
            plen = int(prng.integers(4, 24))
            eng.submit(Request(rid=rid, max_new_tokens=12,
                               prompt=prng.integers(1, scfg.vocab_size, plen)))
        streams[where] = {r.rid: r.out for r in eng.run()}
    print(f"[smoke] {scfg.name} greedy streams, 5 requests through 2 slots: "
          f"card == CPU: {streams['cpu'] == streams['cuda']}")
    if streams["cpu"] != streams["cuda"] or len(streams["cpu"]) != 5:
        raise AssertionError(f"{scfg.name} streams differ: {streams}")


def _smoke_paged(scfg, cpu_params, gpu_params, dev, chunk: int = 16,
                 max_seq: int = 64) -> None:
    """The smoke model through the paged engine on the card and on the CPU,
    whole-prompt, chunked (``chunk`` over 8-token blocks) and as two pods
    behind the router, on a prompt set with duplicates (so blocks are
    shared and copied on write): every greedy stream equals the CPU's and
    the card's dense engine's."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.serve import (PagedServeConfig, PagedServingEngine,
                                   PrefixRouter, Request, ServeConfig,
                                   ServingEngine)

    rng = np.random.default_rng(0)
    base = [rng.integers(1, scfg.vocab_size, int(rng.integers(5, 20)))
            for _ in range(4)]
    prompts = [base[0], base[0].copy(), base[1], base[1].copy(), base[2],
               base[3]]

    def drive(front) -> dict:
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            front.submit(r)
        front.run()
        return {r.rid: list(r.out) for r in reqs}

    models = {"cpu": lm.Model(scfg, cpu_params), "cuda": lm.Model(scfg, gpu_params)}
    dense = drive(ServingEngine(models["cuda"], ServeConfig(max_batch=4, max_seq=max_seq),
                                device=dev))
    for mode, c, pods in (("whole-prompt", 0, 1), (f"chunked ({chunk})", chunk, 1),
                          ("2-pod router", 0, 2)):
        got, counts = {}, {}
        for where in ("cpu", "cuda"):
            engines = [PagedServingEngine(
                models[where], PagedServeConfig(max_batch=4, max_seq=max_seq,
                                                block_tokens=8, n_blocks=32,
                                                chunk=c),
                device=dev if where == "cuda" else "cpu") for _ in range(pods)]
            got[where] = drive(engines[0] if pods == 1 else PrefixRouter(engines))
            counts[where] = [(e.alloc.shared_hits, e.cow_copies, e.prefill_chunks)
                             for e in engines]
            for e in engines:
                _check_pool(e)
        same = got["cpu"] == got["cuda"] and counts["cpu"] == counts["cuda"]
        print(f"[smoke] {scfg.name} paged {mode}: 6 requests, card == CPU: {same}; == dense "
              f"engine on the card: {got['cuda'] == dense}; (shared_hits, "
              f"cow_copies, prefill_chunks) per pod {counts['cuda']}; zero "
              f"block zero and shutdown() clean on both")
        if not same or got["cuda"] != dense:
            raise AssertionError(f"paged smoke streams differ ({mode}): {got}, "
                                 f"dense {dense}")


def _table1_checks(kc) -> tuple[dict, list]:
    """Phase 3b: each Table I kernel against its plain version at both
    configurations' shapes and at the ragged ones, in bf16 and f32.  Returns
    the largest error of each f32 check at table1-card, and the failures."""
    import torch

    errs, failed = {}, []
    shapes = {k: [] for k in ("jacobi", "conv", "dot", "expv", "softmax", "hier",
                              *kc.RAGGED)}
    for cname, cfg in kc.TABLE1.items():
        shapes["jacobi"].append((cname, cfg["jacobi"]))
        shapes["conv"].append((cname, cfg["conv"]))
        shapes["dot"].append((cname, cfg["dot"]))
        shapes["expv"].append((cname, cfg["dot"]))
        shapes["softmax"] += [(cname, rw) for rw in cfg["softmax"]]
        shapes["hier"] += [(cname, (cfg["dot"], C, L, h)) for C, L in cfg["hier"]
                           for h in kc.HIERARCHIES]
    for k, cases in kc.RAGGED.items():
        shapes[k] += [("ragged", c) for c in cases]
    # fconv2d at every filter side, unrolled and generic, square and not,
    # from aligned and unaligned bases: one line a (variant, dtype)
    for dt in (torch.bfloat16, torch.float32):
        worst = {}
        for fr, fc, off in kc.CONV_FILTERS:
            r = kc.check_fconv2d_filter(fr, fc, off, dt)
            key = r["plan"].variant
            n, use = worst.get(key, (0, 0.0))
            worst[key] = (n + 1, max(use, r["limit_use"]))
            if not r["ok"]:
                failed.append(("conv filter", fr, fc, off, dt))
                print(f"[table1] check conv filter {fr}x{fc} offset {off} "
                      f"{str(dt)[6:]} {r['plan']} {_reading(r)}")
        for key, (n, use) in sorted(worst.items()):
            print(f"[table1] check conv filters 1..16 a side {str(dt)[6:]:8s} variant "
                  f"{key or 'generic'}: {n} filters, all ok: {not failed}, largest "
                  f"limit_use {use:.3f}")
    run = {"jacobi": lambda c, dt: kc.check_jacobi2d(*c, dt),
           "conv": lambda c, dt: kc.check_fconv2d(*c, dt),
           "dot": lambda c, dt: kc.check_dotprod(c, dt),
           "expv": lambda c, dt: kc.check_expv(c, dt),
           "softmax": lambda c, dt: kc.check_softmax_rows(*c, dt),
           "softmax_masked": lambda c, dt: kc.check_softmax_rows(*c, dt, masked=True),
           "hier": lambda c, dt: kc.check_dotprod_hier(*c, dt)}
    for k, cases in shapes.items():
        for cname, c in cases:
            for dt in (torch.bfloat16, torch.float32):
                r = run[k](c, dt)
                extra = (f" ulps={r['ulps']}" if k == "expv" else
                         f" {r['branch']}" if k.startswith("softmax") else
                         f" {r['plan']}" if k == "conv" else
                         f"; exact on +-1 inputs: {r['exact_on_signs']}; "
                         "controls' limit_use (must be > 1): " + ", ".join(
                             f"{w} {u:.1f}" for w, u in r["controls"].items())
                         if k in ("dot", "hier") else "")
                print(f"[table1] check {k:14s} {cname:12s} {str(c):32s} "
                      f"{str(dt)[6:]:8s} {_reading(r)}{extra}")
                if cname == "table1-card" and dt == torch.float32:
                    errs[(k, c)] = r["max_abs_err"]
                if not r["ok"]:
                    failed.append((k, cname, c, dt))
                torch.cuda.empty_cache()
    return errs, failed


def _table1_path(kc, ops, ref, dev) -> dict:
    """Phase 5e: the Table I workloads once each through ``ops`` at both
    configurations in f32, every output held against its plain version
    (whose calls launch nothing), the launches checked.  Returns them."""
    import torch

    ops.reset_launches()
    want = {k: 0 for k in ops.LAUNCHES}
    for cname, cfg in kc.TABLE1.items():
        (H, W), (ch, cw, f), n = cfg["jacobi"], cfg["conv"], cfg["dot"]
        x = kc.grid_inputs(H, W, torch.float32, dev, seed=1)
        got = ops.jacobi2d(x)
        checks = [("jacobi2d", kc.compare(got, ref.jacobi2d(x), kc.JACOBI_TOL))]
        xc, filt = kc.conv_inputs(ch, cw, f, torch.float32, dev, seed=1)
        checks.append(("fconv2d", kc.compare(ops.fconv2d(xc, filt),
                                             ref.fconv2d(xc, filt),
                                             (0.0, kc.conv_bound(xc, filt)))))
        del x, got, xc
        a, b = kc.vec_inputs(n, torch.float32, dev, seed=1)
        got = ops.dotprod(a, b)
        checks.append(("dotprod (f64 sum)",
                       kc.compare_dot(got, got, a, b, kc.dot_chain(n))))
        for what, r in kc.dot_controls(a, b, kc.dot_chain(n)).items():
            checks.append((f"dotprod's limit against a dot with {what} (must "
                           f"read above it)", {**r, "ok": not r["ok"]}))
        for C, L in cfg["hier"]:
            for h in kc.HIERARCHIES:
                got = ops.dotprod_hier(a, b, C=C, L=L, hierarchy=h)
                checks.append((f"dotprod_hier {C}x{L} {h} (f64 sum)",
                               kc.compare_dot(got, got, a, b,
                                              kc.hier_chain(n, C, L))))
                want["dotprod"] += 1
        del a, b
        x = kc.exp_inputs(n, torch.float32, dev, seed=1)
        checks.append(("expv", kc.compare_expv(ops.expv(x), ref.expv(x))))
        for R, Wd in cfg["softmax"]:
            x = kc.softmax_inputs(R, Wd, torch.float32, dev, seed=1)
            got = ops.softmax_rows(x)
            r = kc.compare(got, ref.softmax_rows(x), kc.SOFTMAX_TOL[torch.float32])
            row_sums = (got.double().sum(-1) - 1).abs().max().item()
            r["ok"] = r["ok"] and row_sums < 1e-4
            checks.append((f"softmax_rows ({R}, {Wd}) rows sum to 1 within "
                           f"{row_sums:.1e}", r))
            del x, got
        for k in ("dotprod", "expv", "jacobi2d", "fconv2d"):
            want[k] += 1
        want["softmax_rows"] += len(cfg["softmax"])
        for what, r in checks:
            print(f"[table1] path {cname:12s} {what}: {_reading(r)}")
            if not r["ok"]:
                raise AssertionError(f"Table I path, {cname}: {what} disagrees")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    got = dict(ops.LAUNCHES)
    print(f"[table1] path launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"Table I path launches {got}, expected {want}")
    return got


def _json_numbers(v):
    """``v`` with every NaN (a time a trace did not give) as None: JSON has
    no NaN."""
    if isinstance(v, float) and math.isnan(v):
        return None
    if isinstance(v, dict):
        return {k: _json_numbers(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_numbers(x) for x in v]
    return v


def _ms_bound_f32(nbytes: float, nops: float) -> tuple[float, str, float, float]:
    """An f32 row's bound at f32 accuracy: the lesser of the card's two ways
    to do its operations, three TF32 products on the tensor cores
    (``"tf32x3"``) or the CUDA cores (``"f32"``), each the larger of its
    bytes and operations time; returns (bound, what bounds it, the TF32
    bound, the CUDA-core bound)."""
    tc, tc_by = _ms_bound(nbytes, nops, "tf32x3")
    cc, cc_by = _ms_bound(nbytes, nops, "f32")
    return (tc, tc_by, tc, cc) if tc <= cc else (cc, cc_by, tc, cc)


def _sdpa_kernels(fn) -> str:
    """The kernel names of one library call in a trace (which SDPA backend
    ran), the longest first."""
    by = {}
    for e in _kernel_events(fn, 3):
        by[e.name] = by.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    return "; ".join(n[:90] for n, _ in sorted(by.items(), key=lambda kv: -kv[1])[:3])


def _f32_rows(kc, kfa, kmm, ref, time_ms) -> dict:
    """Phase 6's f32 rows of the kernel table, each checked against its
    plain version first, then timed beside the CUDA-core (simt) kernels
    forced in the same run (``variant`` / ``bwd_variant`` lifted to them)
    and the library call (SDPA and its autograd on the KV heads expanded,
    and with ``enable_gqa`` beside them): 3b, flash attention's forward at
    S = 512 (1, 32/8 heads of 128, causal); 3h, its backward at ``FLASH_BWD_CASES[0]`` (4,
    32/8, 1024, 128, causal), the dq and dkv grids apart; 2d, the matmul at
    row 2b's shape (333, 4096) @ (4096, 14336) on its f32 kernel beside
    ``torch.matmul`` in full f32 (TF32 off).  Kernel, plain and library ms
    between CUDA events, device ms from traces, and the bound at f32
    accuracy both ways (``_ms_bound_f32``).  It uses only what the package
    has had since the flash backward came, so ``--only f32`` in a copy of
    this file at an older tree's root reads that tree's kernels.  Returns
    rows "3b", "3h", "2d"."""
    import torch
    import torch.nn.functional as F

    f32 = torch.float32
    Hq, Hkv, D = kc.HQ, kc.HKV, kc.HEAD_DIM
    rows = {}
    # 3b: q and out once, k and v once; 4 D operations a visible pair
    S = 512
    q, k, v = kc.flash_inputs(S, f32)
    kern = lambda: kfa.flash_attention(q, k, v, causal=True)
    # the library on the KV heads expanded (the copy not timed), as
    # _xattn_times: its memory-efficient kernel takes f32 but no GQA, so
    # with enable_gqa SDPA falls to its math path (read beside it)
    ke, ve = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)
    gqa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    r = kc.check_flash_attention(S, f32)
    var = kfa.variant(S, S, D, f32)
    print(f"[check] flash_attention B=1 Hq={Hq} Hkv={Hkv} D={D} S={S} causal float32 {var} "
          f"same bits twice: {r['same_bits']} {_reading(r)}")
    if not r["ok"]:
        raise AssertionError(f"flash_attention f32 ({var}) disagrees at row 3b: {r}")
    t_k, t_l = time_ms(kern, 50), time_ms(sdpa, 50)
    t_p = time_ms(lambda: ref.attention(q, k, v, causal=True), 10)
    d_k, d_l, d_g = _device_call(kern, 20), _device_call(sdpa, 20), _device_call(gqa, 20)
    pro, _ = _device_ms(kern, "flash_tf32_split", 20)
    chooser = kfa.variant
    kfa.variant = lambda *a, **kw: "simt"
    try:
        t_s, d_s = time_ms(kern, 20), _device_call(kern, 20)
    finally:
        kfa.variant = chooser
    bound, by, b_tc, b_cc = _ms_bound_f32(4 * S * D * (2 * Hq + 2 * Hkv),
                                          4.0 * D * Hq * S * (S + 1) / 2)
    rows["3b"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound, bound_by=by,
                      tf32x3_bound_ms=b_tc, cuda_core_bound_ms=b_cc, device_ms=d_k,
                      prologue_device_ms=pro, library_device_ms=d_l,
                      library_gqa_device_ms=d_g, simt_ms=t_s, simt_device_ms=d_s, variant=var,
                      max_abs_err=r["max_abs_err"],
                      shape=f"B=1,Hq={Hq},Hkv={Hkv},S={S},D={D},causal,f32")
    print(f"[time] 3b flash_attention B=1 Hq={Hq} Hkv={Hkv} D={D} S={S} causal f32 {var} "
          f"kernel {t_k:.4f} ms (simt {t_s:.4f})  plain {t_p:.4f} ms  SDPA {t_l:.4f} ms  "
          f"bound {bound:.5f} ms ({by}; three TF32 products {b_tc:.5f}, CUDA cores "
          f"{b_cc:.5f}); device: kernel {d_k:.4f} ms (its K/V split {pro:.4f}), simt "
          f"{d_s:.4f} ms, SDPA {d_l:.4f} ms, {d_k / d_l:.2f}x SDPA, {d_s / d_k:.2f}x "
          f"faster than simt, {d_k / bound:.1f}x bound; SDPA ran {_sdpa_kernels(sdpa)}; "
          f"with enable_gqa dev {d_g:.4f} ms, ran {_sdpa_kernels(gqa)}")
    del q, k, v, ke, ve
    # 3h: q, k, v, do read, dq, dk, dv written; five products a visible pair
    B, S, _ = kc.FLASH_BWD_CASES[0]
    q, k, v, do = kc.attention_bwd_inputs(B, S, f32)
    r = kc.check_flash_bwd(B, S, f32)
    var = kfa.bwd_variant(S, S, D, f32)
    print(f"[check] flash_attention_bwd B={B} Hq={Hq} Hkv={Hkv} D={D} S={S} causal float32 "
          f"{var} same bits twice: {r['same_bits']} {_reading(r)}")
    if not r["ok"]:
        raise AssertionError(f"flash_attention_bwd f32 ({var}) disagrees at row 3h: {r}")
    fk = lambda: kfa.backward(q, k, v, do, causal=True)
    # autograd of SDPA on the KV heads expanded, as at 3b (dk and dv left
    # per q head), and with enable_gqa beside it
    ke, ve = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, ke, ve))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    fl = lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    fg = lambda: torch.autograd.grad(og, (qg, kg, vg), do, retain_graph=True)
    t_k, t_l = time_ms(fk, 10), time_ms(fl, 10)
    t_p = time_ms(lambda: ref.attention_bwd(q, k, v, do, causal=True), 1)
    tags = {"tf32x3": ("flash_bwd_dq_tf32", "flash_bwd_dkv_tf32"),
            "simt": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
    (dq, _), (dkv, _) = (_device_ms(fk, tag, 10) for tag in tags[var])
    d_l, d_g = _device_call(fl, 10), _device_call(fg, 10)
    chooser = kfa.bwd_variant
    kfa.bwd_variant = lambda *a, **kw: "simt"
    try:
        t_s = time_ms(fk, 5)
        (sq, _), (skv, _) = (_device_ms(fk, tag, 5) for tag in tags["simt"])
    finally:
        kfa.bwd_variant = chooser
    pairs = B * Hq * S * (S + 1) / 2
    bound, by, b_tc, b_cc = _ms_bound_f32(4 * B * S * D * (2 * Hq + 2 * Hkv) * 2,
                                          5 * 2.0 * pairs * D)
    rows["3h"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound, bound_by=by,
                      tf32x3_bound_ms=b_tc, cuda_core_bound_ms=b_cc, device_ms=dq + dkv,
                      dq_device_ms=dq, dkv_device_ms=dkv, library_device_ms=d_l,
                      library_gqa_device_ms=d_g, simt_ms=t_s,
                      simt_device_ms=sq + skv, simt_dq_device_ms=sq, simt_dkv_device_ms=skv,
                      variant=var, max_abs_err=r["max_abs_err"],
                      shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},D={D},causal,f32")
    print(f"[time] 3h flash_attention_bwd B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} causal f32 "
          f"{var} kernel {t_k:.4f} ms (simt {t_s:.4f})  plain {t_p:.4f} ms  SDPA backward "
          f"(autograd) {t_l:.4f} ms  bound {bound:.4f} ms ({by}; three TF32 products "
          f"{b_tc:.4f}, CUDA cores {b_cc:.4f}); device: dq {dq:.4f} + dkv {dkv:.4f} = "
          f"{dq + dkv:.4f} ms (simt {sq:.4f} + {skv:.4f} = {sq + skv:.4f}), SDPA backward "
          f"{d_l:.4f} ms, {(dq + dkv) / d_l:.2f}x SDPA's, {(sq + skv) / (dq + dkv):.2f}x "
          f"faster than simt, {(dq + dkv) / bound:.1f}x bound; SDPA's backward ran "
          f"{_sdpa_kernels(fl)}; with enable_gqa dev {d_g:.4f} ms, ran {_sdpa_kernels(fg)}")
    del q, k, v, do, ke, ve, ql, kl, vl, ol, qg, kg, vg, og
    # 2d: a and b read once, c written once
    M, K, N = 333, 4096, 14336
    r = kc.check_matmul(M, K, N, f32)
    var = kmm.variant(M, K, N, f32)
    if not r["ok"]:
        raise AssertionError(f"matmul f32 ({var}) disagrees at row 2d: {r}")
    a, b = kc.matmul_inputs(M, K, N, f32)
    kern, lib = (lambda: kmm.matmul(a, b)), (lambda: torch.matmul(a, b))
    t_k, t_l = time_ms(kern, 10), time_ms(lib, 10)
    t_p = time_ms(lambda: ref.matmul(a, b), 5)
    d_k, d_l = _device_call(kern, 10), _device_call(lib, 10)
    bound, by, b_tc, b_cc = _ms_bound_f32(4 * (M * K + K * N + M * N), 2.0 * M * K * N)
    rows["2d"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound, bound_by=by,
                      tf32x3_bound_ms=b_tc, cuda_core_bound_ms=b_cc, device_ms=d_k,
                      library_device_ms=d_l, variant=var, max_abs_err=r["max_abs_err"],
                      shape=f"M={M},K={K},N={N},f32")
    print(f"[time] 2d matmul M={M} K={K} N={N} f32 {var} kernel {t_k:.4f} ms  plain "
          f"{t_p:.4f} ms  torch.matmul (TF32 off) {t_l:.4f} ms  bound {bound:.4f} ms ({by}; "
          f"three TF32 products {b_tc:.4f}, CUDA cores {b_cc:.4f}); device: kernel "
          f"{d_k:.4f} ms, torch.matmul {d_l:.4f} ms, {d_k / d_l:.2f}x torch.matmul, "
          f"{d_k / bound:.1f}x bound, {d_k / b_cc:.2f}x the CUDA-core bound")
    return rows


def _f32_part(dev, m) -> dict:
    """``--only f32``: the flash libraries' ptxas lines (phase 2's), then
    phase 6's f32 rows (``_f32_rows``)."""
    from repro_torch.kernels import _build

    for lib in ("flash_attention", "flash_attention_bwd"):
        for line in _ptxas_summary(_build.BUILD_LOGS.get(lib, "")):
            print(f"[build]   {lib}: {line}")
    return _f32_rows(m.kc, m.kfa, m.kmm, m.ref, _time_ms)


def _time_ms(fn, iters: int) -> float:
    """ms a call of ``fn`` between CUDA events, over ``iters`` calls after
    three warm-up calls."""
    import torch

    for _ in range(3):
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


def _kernel_events(fn, calls: int) -> list:
    """The card's kernels in a torch.profiler trace of ``calls`` calls of
    ``fn`` (it may miss the first few; a trace that holds no kernel at all
    is taken again, up to twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if evs:
            break
    return evs


def _ms(evs) -> float:
    return sum(e.time_range.end - e.time_range.start for e in evs) / 1e3


def _device_ms(fn, tag: str, calls: int) -> tuple[float, int]:
    """The mean device time of the kernels named ``tag`` in a trace of
    ``calls`` calls of ``fn``, and how many of them the trace holds; (nan,
    0) if it holds none."""
    evs = [e for e in _kernel_events(fn, calls) if tag in e.name]
    return (_ms(evs) / len(evs), len(evs)) if evs else (float("nan"), 0)


def _device_call(fn, calls: int) -> float:
    """Device ms a call of ``fn`` from a trace of ``calls`` calls: each
    kernel name in the trace at the mean of its kernels, times its launches
    a call (the trace's count over the calls, rounded, at least one),
    summed; a trace that misses a few kernels does not read low.  nan if it
    holds none.  (``_device_ms`` reads one kernel by name.)"""
    by_name = {}
    for e in _kernel_events(fn, calls):
        by_name.setdefault(e.name, []).append(e)
    if not by_name:
        return float("nan")
    return sum(max(1, round(len(evs) / calls)) * _ms(evs) / len(evs)
               for evs in by_name.values())


def _table1_times(kc, kred, kst, ref, time_ms, dev) -> dict:
    """Phase 6, Table I: kernel, plain, library (one PyTorch call of the same
    function; cuDNN without TF32 for the convolutions) and the card's bound
    at both configurations, f32.  Bound: each input read once, each output
    written once; operations per element as counted in each line.  At
    table1-paper, where every operand sits in L2, the kernel's own device
    time and the library call's from profiler traces too, to part the
    host's cost from the card's, and dotprod's and expv's host cost a call
    in turns with the library's."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for cname, cfg in kc.TABLE1.items():
        card = cname == "table1-card"
        it_k, it_p = (20, 3) if card else (200, 50)

        def row(kname, shape, fk, fp, fl, nbytes, nops, lib, tag):
            t_k, t_p = time_ms(fk, it_k), time_ms(fp, it_p)
            t_l = time_ms(fl, it_k)
            bound, by = _ms_bound(nbytes, nops, "f32")
            calls = 10 if card else 50
            if card and kname != "fconv2d":
                t_d, n_d, t_ld = float("nan"), 0, float("nan")
            else:
                t_d, n_d = _device_ms(fk, tag, calls)
                t_ld = _device_call(fl, calls)
            # the first shape of a kernel stands for it in the kernels line
            rows.setdefault((kname, cname),
                            (t_k, t_p, t_l, bound, by, shape, t_d, t_ld))
            device = "" if n_d == 0 else (f"; device: {tag} {t_d:.4f} ms (mean of "
                                          f"{n_d} in a trace of {calls} calls), {lib} "
                                          f"{t_ld:.4f} ms a call")
            print(f"[time] {kname:12s} {cname:12s} {shape:34s} f32 kernel "
                  f"{t_k:.4f} ms  plain {t_p:.4f} ms  {lib} {t_l:.4f} ms  "
                  f"bound {bound:.3g} ms ({by}){device}")

        H, W = cfg["jacobi"]
        x = kc.grid_inputs(H, W, torch.float32, dev)
        cross = torch.tensor([[0, .25, 0], [.25, 0, .25], [0, .25, 0]],
                             device=dev)[None, None]
        # 3 adds and a multiply an element
        row("jacobi2d", f"({H}, {W})", lambda: kst.jacobi2d(x),
            lambda: ref.jacobi2d(x),
            lambda: F.conv2d(x[None, None], cross, padding=1),
            8 * H * W, 4 * H * W, "F.conv2d", "jacobi_kernel")
        del x
        ch, cw, f = cfg["conv"]
        x, filt = kc.conv_inputs(ch, cw, f, torch.float32, dev)
        oh, ow = ch - f + 1, cw - f + 1
        row("fconv2d", f"({ch}, {cw}) * {f}x{f} -> ({oh}, {ow})",
            lambda: kst.fconv2d(x, filt), lambda: ref.fconv2d(x, filt),
            lambda: F.conv2d(x[None, None], filt[None, None]),
            4 * (ch * cw + oh * ow + f * f), 2 * f * f * oh * ow, "F.conv2d",
            "conv_kernel")
        del x
        n = cfg["dot"]
        a, b = kc.vec_inputs(n, torch.float32, dev)
        row("dotprod", f"n={n}", lambda: kred.dotprod(a, b),
            lambda: ref.dotprod(a, b), lambda: torch.dot(a, b),
            8 * n + 4, 2 * n, "torch.dot", "dot_kernel")
        for C, L in cfg["hier"]:
            for h in kc.HIERARCHIES:
                row("dotprod_hier", f"n={n} {C}x{L} {h}",
                    lambda: kred.dotprod_hier(a, b, C=C, L=L, hierarchy=h),
                    lambda: ref.dotprod(a, b), lambda: torch.dot(a, b),
                    8 * n + 4, 2 * n, "torch.dot", "dot_kernel")
        del a, b
        x = kc.exp_inputs(n, torch.float32, dev)
        xc = x.clamp(-80, 80)
        # clip 2, multiply 1, round 1, 7 fused multiply-adds 14, exponent 2
        row("expv", f"n={n}", lambda: kred.expv(x), lambda: ref.expv(x),
            lambda: torch.exp(xc), 8 * n, 20 * n, "torch.exp", "expv_kernel")
        del x, xc
        for R, Wd in cfg["softmax"]:
            x = kc.softmax_inputs(R, Wd, torch.float32, dev)
            branch = kc.softmax_branch(x)
            tag = PORT_KERNELS[f"softmax_rows {branch}"]
            # max, subtract, exp, add, divide: ~5 an element
            row("softmax_rows", f"({R}, {Wd}) {branch}", lambda: kred.softmax_rows(x),
                lambda: ref.softmax_rows(x), lambda: torch.softmax(x, -1),
                8 * R * Wd, 5 * R * Wd, "torch.softmax", tag)
            del x
        torch.cuda.empty_cache()
    # each Table I kernel's host cost a call: back-to-back calls at
    # table1-paper, where the kernel takes a few us of device time, between
    # events, in turns with the library call (kernel, library, library,
    # kernel); F.conv2d's own device time is ~0.036 ms there, so its number
    # is that, not its host's
    n = kc.TABLE1["table1-paper"]["dot"]
    xj = kc.grid_inputs(*kc.TABLE1["table1-paper"]["jacobi"], torch.float32, dev)
    cross = torch.tensor([[0, .25, 0], [.25, 0, .25], [0, .25, 0]], device=dev)[None, None]
    xconv, fconv = kc.conv_inputs(*kc.TABLE1["table1-paper"]["conv"], torch.float32, dev)
    a, b = kc.vec_inputs(n, torch.float32, dev)
    x = kc.exp_inputs(n, torch.float32, dev)
    xc = x.clamp(-80, 80)
    xs = kc.softmax_inputs(*kc.TABLE1["table1-paper"]["softmax"][0], torch.float32, dev)
    for kname, fk, lib, fl in (
            ("dotprod", lambda: kred.dotprod(a, b), "torch.dot", lambda: torch.dot(a, b)),
            ("expv", lambda: kred.expv(x), "torch.exp", lambda: torch.exp(xc)),
            ("softmax_rows", lambda: kred.softmax_rows(xs), "torch.softmax",
             lambda: torch.softmax(xs, -1)),
            ("jacobi2d", lambda: kst.jacobi2d(xj), "F.conv2d",
             lambda: F.conv2d(xj[None, None], cross, padding=1)),
            ("fconv2d", lambda: kst.fconv2d(xconv, fconv), "F.conv2d",
             lambda: F.conv2d(xconv[None, None], fconv[None, None]))):
        host = {"kernel": [], "library": []}
        for turn, fn in (("kernel", fk), ("library", fl), ("library", fl),
                         ("kernel", fk)):
            host[turn].append(1e3 * time_ms(fn, 500))
        rows[(kname, "host")] = host
        what = {"softmax_rows": f"{tuple(xs.shape)}", "jacobi2d": f"{tuple(xj.shape)}",
                "fconv2d": f"{tuple(xconv.shape)} * 7x7"}.get(kname, f"n={n}")
        print(f"[time] {kname} host cost {what} f32, us a call in turns: kernel "
              + " / ".join(f"{t:.1f}" for t in host["kernel"]) + f"; {lib} "
              + " / ".join(f"{t:.1f}" for t in host["library"]))
    return rows


def _backward_checks(kc, kfa) -> tuple[dict, list]:
    """Phase 3c: each backward kernel against its plain version, twice for
    the same bits; one line a case.  Returns the largest errors and the
    failed cases."""
    import torch

    errs, failed = {}, []
    dts = (torch.bfloat16, torch.float32)

    def line(tag, r, extra=""):
        parts = " ".join(f"{k} {v['limit_use']:.3f}" for k, v in r["parts"].items()) \
            if "parts" in r else ""
        print(f"[check] {tag} {extra}same bits twice: {r['same_bits']} "
              f"{_reading(r)}{' (limit use ' + parts + ')' if parts else ''}")

    # the training shapes, ragged ones, and phi3-mini's width (phase 7b)
    for R, D in kc.RMSNORM_BWD_CASES + ((kc.TRAIN_TOKENS, kc.PHI3_D_MODEL),):
        for dt in dts:
            r = kc.check_rmsnorm_bwd(R, D, dt)
            errs[("rmsnorm_bwd", R, D, dt)] = r["max_abs_err"]
            line(f"rmsnorm_bwd R={R:<4d} D={D} {str(dt)[6:]:8s} {r['path']:6s}", r)
            if not r["ok"]:
                failed.append(("rmsnorm_bwd", R, D, dt))
    shapes = [(proj, kc.TRAIN_TOKENS, K, N) for proj, (K, N) in kc.MATMUL_KN.items()]
    shapes += [("ragged", M, K, N) for M, K, N in kc.MATMUL_BWD_RAGGED]
    shapes += [(f"phi3 {proj}", kc.TRAIN_TOKENS, K, N)
               for proj, (K, N) in kc.PHI3_MATMUL_KN.items()]
    for proj, M, K, N in shapes:
        for dt in dts:
            for which in "ab":
                r = kc.check_matmul_bwd(M, K, N, dt, which)
                errs[("matmul_bwd", which, M, K, N, dt)] = r["max_abs_err"]
                line(f"matmul_bwd d{which.upper()} {proj:7s} M={M:<4d} K={K:<5d} "
                     f"N={N:<5d} {str(dt)[6:]:8s} {r['variant']:5s}", r)
                if not r["ok"]:
                    failed.append(("matmul_bwd", which, proj, M, K, N, dt))
    for B, S, window in kc.FLASH_BWD_CASES:
        for dt in dts:
            r = kc.check_flash_bwd(B, S, dt, window)
            errs[("flash_attention_bwd", B, S, window, dt)] = r["max_abs_err"]
            line(f"flash_attention_bwd B={B} Hq={kc.HQ} Hkv={kc.HKV} D={kc.HEAD_DIM} "
                 f"S={S:<4d} causal window={window} {str(dt)[6:]:8s} {r['variant']:5s}", r)
            # bf16 and f32 at these heads through the tensor cores
            if not r["ok"] or r["variant"] != ("wgmma" if dt == torch.bfloat16 else "tf32x3"):
                failed.append(("flash_attention_bwd", B, S, window, dt))
    # the wgmma kernels' other head dim at the training length
    B, S, D = kc.FLASH_BWD_D64
    r = kc.check_flash_bwd(B, S, torch.bfloat16, None, True, kc.HQ, kc.HKV, D)
    line(f"flash_attention_bwd B={B} Hq={kc.HQ} Hkv={kc.HKV} D={D} S={S:<4d} causal "
         f"window=None bfloat16 {r['variant']:5s}", r)
    if not r["ok"] or r["variant"] != "wgmma":
        failed.append(("flash_attention_bwd", B, S, D))
    # phi3-mini's heads (32 over 32 of 96) at the training length: wgmma in
    # bf16, tf32x3 in f32
    B, S = kc.PHI3_FLASH_BWD
    for dt in dts:
        r = kc.check_flash_bwd(B, S, dt, None, True, kc.PHI3_HQ, kc.PHI3_HKV, kc.PHI3_HEAD_DIM)
        errs[("flash_attention_bwd phi3", B, S, dt)] = r["max_abs_err"]
        line(f"flash_attention_bwd B={B} Hq={kc.PHI3_HQ} Hkv={kc.PHI3_HKV} "
             f"D={kc.PHI3_HEAD_DIM} S={S:<4d} causal window=None {str(dt)[6:]:8s} "
             f"{r['variant']:5s}", r)
        if not r["ok"] or r["variant"] != ("wgmma" if dt == torch.bfloat16 else "tf32x3"):
            failed.append(("flash_attention_bwd phi3", B, S, dt))
    # head dim 96 in bf16, forward and backward, every head, into outputs
    # with guard columns after each row
    for B, S, Hq, Hkv, window in kc.D96_CASES:
        for layout in kc.D96_LAYOUTS:
            r = kc.check_flash_d96(B, S, Hq, Hkv, window, layout)
            line(f"flash_attention d96 fwd+bwd B={B} Hq={Hq} Hkv={Hkv} D=96 S={S:<4d} "
                 f"causal window={window} {layout} bfloat16 {r['variant']:5s} guard "
                 f"columns intact: {r['guard_intact']}", r)
            if not r["ok"] or r["variant"] != "wgmma":
                failed.append(("flash_attention d96", B, S, Hq, Hkv, window, layout))
    for D in kfa.HEAD_DIMS:
        for causal in (True, False):
            for dt in dts:
                r = kc.check_flash_bwd(2, 70, dt, 9, causal, 4, 2, D)
                line(f"flash_attention_bwd B=2 Hq=4 Hkv=2 D={D:<3d} S=70 "
                     f"{'causal' if causal else 'full  '} window=9 {str(dt)[6:]:8s} "
                     f"{r['variant']:5s}", r)
                if not r["ok"]:
                    failed.append(("flash_attention_bwd head dim", D, causal, dt))
    return errs, failed


def _family_checks(kc, kmm) -> tuple[dict, list]:
    """Phases 3 and 3c at the shapes the MoE training and Mamba2 paths give
    the kernels, each twice for the same bits, one line a case naming the
    variant taken: mamba2-370m's ``in_proj`` (N = 4,384: an edge tile of
    32 columns, read alone too) and ``out_proj`` (K = 2,048) at a decode
    step's, a prefill's and a train step's rows, forward and both backward
    products at the train step's; rmsnorm at D = 1,024 and 2,048 forward,
    and backward at 4,096 rows; mixtral-8x7b's expert products at its train
    step's C = 1,280 buffer rows and at a C that is not a multiple of 8
    (dW then takes simt), forward, dX and dW; flash attention at mixtral's
    train shape (4, 32/8, 1024, 128, window 4,096), forward and backward.
    Returns the largest errors and the failed cases."""
    import torch

    errs, failed = {}, []
    dts = (torch.bfloat16, torch.float32)

    def note(key, r, line):
        errs[key] = r["max_abs_err"]
        print(f"[check] {line} same bits twice: {r['same_bits']} {_reading(r)}")
        if not r["ok"]:
            failed.append(key)

    for proj, (K, N) in kc.MAMBA_MATMUL_KN.items():
        for M in kc.MAMBA_ROWS:
            for dt in dts:
                r = kc.check_matmul(M, K, N, dt)
                note(("matmul mamba", proj, M, dt), r,
                     f"matmul mamba {proj:8s} M={M:<4d} K={K:<5d} N={N:<5d} "
                     f"{str(dt)[6:]:8s} {kmm.variant(M, K, N, dt):6s} edge columns "
                     f"limit_use={r['edge']['limit_use']:.3f}")
        for dt in dts:
            for which in "ab":
                M = kc.TRAIN_TOKENS
                r = kc.check_matmul_bwd(M, K, N, dt, which)
                note(("matmul_bwd mamba", proj, which, dt), r,
                     f"matmul_bwd d{which.upper()} mamba {proj:8s} M={M:<4d} K={K:<5d} "
                     f"N={N:<5d} {str(dt)[6:]:8s} {r['variant']:5s}")
    for D in kc.MAMBA_NORM_D:
        for dt in dts:
            for R in kc.MAMBA_ROWS:
                r = kc.check_rmsnorm(R, D, dt)
                note(("rmsnorm mamba", R, D, dt), r,
                     f"rmsnorm mamba R={R:<4d} D={D} {str(dt)[6:]:8s}")
            r = kc.check_rmsnorm_bwd(kc.TRAIN_TOKENS, D, dt)
            note(("rmsnorm_bwd mamba", D, dt), r,
                 f"rmsnorm_bwd mamba R={kc.TRAIN_TOKENS} D={D} {str(dt)[6:]:8s} "
                 f"{r['path']:6s}")
    for C in kc.MOE_TRAIN_C:
        for proj, (K, N) in kc.MOE_KN.items():
            for dt in dts:
                r = kc.check_matmul(C, K, N, dt)
                note(("matmul moe train", proj, C, dt), r,
                     f"matmul moe expert {proj:7s} M=C={C:<5d} K={K:<5d} N={N:<5d} "
                     f"{str(dt)[6:]:8s} {kmm.variant(C, K, N, dt):6s}")
                for which in "ab":
                    r = kc.check_matmul_bwd(C, K, N, dt, which)
                    note(("matmul_bwd moe train", proj, C, which, dt), r,
                         f"matmul_bwd d{which.upper()} moe expert {proj:7s} C={C:<5d} "
                         f"K={K:<5d} N={N:<5d} {str(dt)[6:]:8s} {r['variant']:5s}")
    B, S, window = kc.MIXTRAL_TRAIN_FLASH
    for dt in dts:
        r = kc.check_flash_attention(S, dt, window, B=B)
        note(("flash_attention mixtral train", dt), r,
             f"flash_attention mixtral train B={B} Hq={kc.HQ} Hkv={kc.HKV} "
             f"D={kc.HEAD_DIM} S={S} causal window={window} {str(dt)[6:]:8s} "
             f"{r['variant']:5s}")
        r = kc.check_flash_bwd(B, S, dt, window)
        note(("flash_attention_bwd mixtral train", dt), r,
             f"flash_attention_bwd mixtral train B={B} S={S} window={window} "
             f"{str(dt)[6:]:8s} {r['variant']:5s}")
    return errs, failed


def _smoke_train(dev) -> dict:
    """Phase 4b: each smoke model's loss, gradients and two train steps on
    the card against the CPU, from the JAX initialiser's weights
    (``train_checks.SMOKE_ARCHS``: llama3-8b, the MoE family, mamba2,
    jamba, which is held at its start: ``train_checks.START_ONLY``, and
    the cross-attention families).
    Returns the launches of the card's runs."""
    from repro_torch.kernels import ops
    from repro_torch.testing import train_checks as tc

    total = dict.fromkeys(ops.LAUNCHES, 0)
    for arch in tc.SMOKE_ARCHS:
        ops.reset_launches()
        card = tc.run_smoke(dev, steps=2, arch=arch)
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        for k, v in got.items():
            total[k] += v
        cpu = tc.run_smoke("cpu", steps=2, arch=arch)
        r = tc.compare_runs(card, cpu, arch=arch)
        print(f"[train-smoke] {arch}-smoke f32 from the JAX init "
              f"({tc.weights_path(arch).name}), loss {card['loss0']:.6f} (CPU "
              f"{cpu['loss0']:.6f}), 2 steps: losses "
              f"{[round(m['loss'], 6) for m in card['metrics']]} (CPU "
              f"{[round(m['loss'], 6) for m in cpu['metrics']]}); card vs CPU, "
              f"held: the {r['held']}: scalars {r['scalar_rel']:.2e} (rtol "
              f"{tc.SCALAR_RTOL:.0e}), gradient leaves' limit use "
              f"{r['grad_limit_use']:.3f}, params p99.9 {r['param_p999']:.2e} (<= "
              f"{tc.PARAM_P999:.0e}) max {r['param_max']:.2e} (<= {tc.PARAM_MAX:.0e}), "
              f"m/v {r['state_rel']:.2e} (<= {tc.STATE_TOL:.0e}): "
              f"{'ok' if r['ok'] else 'FAIL'}; launches on the card {got}")
        if not r["ok"]:
            raise AssertionError(f"{arch} smoke training differs between card and "
                                 f"CPU: {r}")
        need = ["rmsnorm", "matmul", "rmsnorm_bwd", "matmul_bwd"]
        if arch != "mamba2-370m":
            need += ["flash_attention", "flash_attention_bwd"]
        if not all(got.get(k) for k in need):
            raise AssertionError(f"the {arch} smoke train step missed a kernel: {got}")
    return total


def _step_bound(cfg, B: int, S: int, n_params: int) -> tuple:
    """The least time of one train step (ms, what bounds it, bf16 FLOP, f32
    FLOP): the
    products' 2 K N a row forward, 4 K N backward and 2 K N again under
    remat (attention's 4 projections, an MLP's 3, a MoE's 3 an expert on
    each of its C buffer rows, a Mamba's 2), the head's 6 d V a token (no
    remat), causal attention's Q K^T and P V forward (twice under remat)
    and the five products of its backward over the visible pairs, all bf16
    on the tensor cores; the SSD's f32 einsums (a chunk's C B^T, its decay
    applied to x, the chunk states and their read-out) at the CUDA cores'
    f32 peak, the same 1 + r + 2 passes; against each parameter's 16 bytes
    (bf16 weight and gradient, f32 master, m and v) read and written once
    by the update.  The least time is the largest of the three.  With a
    context of Tc = B x ``lm.context_len`` rows: a cross-attention
    sublayer's ``wq``, ``wo`` over the T rows and ``wk``, ``wv`` over the
    Tc rows, its non-causal attention over B H S Tc pairs; an encoder
    layer's 4 projections and MLP over the Tc rows and its attention over
    B H Tc Tc pairs, each the same 1 + r + 2 passes; ``ctx_proj``'s product
    forward and its dW (2 passes, no remat)."""
    from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE, XATTN
    from repro_torch.models import lm
    from repro_torch.models.layers import moe_capacity, ssd_chunk_len

    T = B * S
    d, hd = cfg.d_model, cfg.head_dim
    r = 2 if cfg.remat else 1
    kinds = [k for layer in cfg.layer_period for k in layer]
    n = {k: kinds.count(k) * cfg.n_periods for k in (ATTN, MLP, MOE, MAMBA, XATTN)}
    ffe = cfg.d_ff_expert or cfg.d_ff
    di, N, H = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    macs = T * n[ATTN] * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                          + cfg.n_heads * hd * d)
    macs += T * n[MLP] * 3 * d * cfg.d_ff
    if n[MOE]:
        macs += n[MOE] * cfg.n_experts * moe_capacity(cfg, T) * 3 * d * ffe
    macs += T * n[MAMBA] * d * (2 * di + 2 * N + H + di)
    Sc = lm.context_len(cfg, S) if cfg.family in lm.CONTEXT_FAMILIES else 0
    Le = cfg.n_enc_layers if cfg.family == "encdec" else 0
    macs += n[XATTN] * (T * 2 * cfg.n_heads * hd * d + B * Sc * 2 * cfg.n_kv_heads * hd * d)
    macs += Le * B * Sc * (d * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd + 3 * d * cfg.d_ff)
    proj = 2 * (r + 2) * macs + 2 * 2 * B * Sc * cfg.d_ctx * d
    head = 6 * d * cfg.padded_vocab * T
    pairs = B * cfg.n_heads * S * (S + 1) / 2
    pairs_x = B * cfg.n_heads * (n[XATTN] * S * Sc + Le * Sc * Sc)
    attn = (2 * r + 5) * 2 * (pairs * n[ATTN] + pairs_x) * hd
    flop = proj + head + attn
    Q = ssd_chunk_len(cfg.ssm_chunk, S) if n[MAMBA] else 1
    ssd = (1 + r + 2) * 2 * T * n[MAMBA] * (Q * N + Q * di + 2 * di * N)
    ms, by = _ms_bound(2 * 16 * n_params, flop, "bf16")
    ssd_ms = 1e3 * ssd / PEAK_OPS_S["f32"]
    if ssd_ms > ms:
        ms, by = ssd_ms, "operations"
    return ms, by, flop, ssd


def _split(tr: dict, cfg, steps: int, what: str) -> None:
    """A traced step split by direction and sublayer, in launch order: a
    forward rmsnorm opens a forward segment, the first backward kernel
    after forward ones opens a backward segment, and the kernel after a
    backward's dgamma sum opens the next; a segment with at least 3E
    forward (or 6E backward) products is MoE, one with an attention kernel
    or 4 (8) products attention (a dense-cache decode step's is plain
    torch), with 3 (6) an MLP, with fewer a Mamba sublayer's half, with
    none the embedding, head, loss and update.  A kernel the trace missed
    can move a segment to another kind.  Each row's device ms a step by
    kernel class: the port's products, norms and attention, and plain
    torch (the router and dispatch, the SSD and conv, gates, adds).  A
    sublayer's plain-torch backward kernels that run before its first
    backward product count to the segment before it."""
    if not tr["events"]:
        print(f"[split] {what}: the profiler recorded no device activity: not measured")
        return
    port = lambda fam: fam.endswith("(port)")
    bwd = lambda fam: port(fam) and "_bwd" in fam
    segs, cur, cur_bwd = [], [], False
    for fam, us in tr["seq"]:
        fwd_norm = port(fam) and fam.startswith("rmsnorm") and not bwd(fam)
        if cur and (fwd_norm or (bwd(fam) and not cur_bwd)):
            segs.append((cur_bwd, cur))
            cur = []
        cur_bwd = bwd(fam) or (cur_bwd and not fwd_norm)
        cur.append((fam, us))
        if fam.startswith("rmsnorm_bwd dgamma"):
            segs.append((True, cur))
            cur = []
    segs.append((cur_bwd, cur))
    E = max(cfg.n_experts, 1)
    rows: dict = {}
    for back, seg in segs:
        if not seg:
            continue
        mm = sum(port(f) and f.startswith("matmul") for f, _ in seg)
        per = 2 if back else 1
        attn = any(port(f) and f.startswith(("flash", "paged")) for f, _ in seg)
        kind = ("MoE" if cfg.n_experts and mm >= 3 * E * per
                else "attention" if attn or mm == 4 * per
                else "MLP" if mm == 3 * per
                else "Mamba" if mm else "embedding, head, loss, update")
        row = rows.setdefault(("backward" if back else "forward", kind),
                              {"products": 0.0, "norms": 0.0, "attention": 0.0,
                               "plain torch": 0.0, "launches": 0})
        for fam, us in seg:
            cls = ("plain torch" if not port(fam) else "products"
                   if fam.startswith("matmul") else "norms"
                   if fam.startswith("rmsnorm") else "attention")
            row[cls] += us / 1e3 / steps
            row["launches"] += 1 / steps
    for (direction, kind), row in sorted(rows.items()):
        print(f"[split] {what}, {direction} {kind}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in row.items() if k != "launches" and v)
            + f" ({row['launches']:.0f} launches a step)")


def _train_path(cfg, dev, n_layers: int = 8, batch: int = 4, seq: int = 1024,
                steps: int = 3, opt_cfg=None, falling: bool = False) -> dict:
    """Phase 7 (and the training parts of phases 8 and 9): the full-width
    model cut to ``n_layers``, ``steps`` train steps through the kernels
    (``OptConfig`` defaults unless ``opt_cfg``), the loss on the first
    batch after them (with ``falling`` it must be below its loss at the
    start), and a traced step split by sublayer.  An encdec or vlm model's
    batches carry the train launcher's contexts (``step_context``).
    Returns the launches."""
    import dataclasses

    import torch

    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.params import tree_leaves
    from repro_torch.testing.timing import now
    from repro_torch.train import OptConfig, adamw_update, make_train_step
    from repro_torch.train.trainer import (init_train_state, loss_and_grads,
                                           step_launches)

    from repro_torch.models import lm

    tcfg = dataclasses.replace(cfg, n_layers=n_layers)
    opt_cfg = opt_cfg or OptConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = now()
    state = init_train_state(tcfg, opt_cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"[train] {tcfg.name}: {n_layers} layers of {cfg.n_layers}, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {str(cfg.dtype)[6:]}, remat "
          f"{tcfg.remat}, loss_chunk {tcfg.loss_chunk}; {n_params / 1e9:.3f} B "
          f"params, state {torch.cuda.memory_allocated() / 1e9:.2f} GB, drawn in "
          f"{now() - t0:.1f}s; batch {batch} x {seq} tokens, {opt_cfg}")
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch, seed=0))
    batches = [{"tokens": torch.from_numpy(corpus.batch(i)).to(dev, torch.int64)}
               for i in range(steps)]
    if cfg.family in lm.CONTEXT_FAMILIES:
        from repro_torch.launch.train import step_context
        t0 = now()
        for i, b in enumerate(batches):
            b["ctx"] = torch.from_numpy(step_context(tcfg, i, batch, seq)).to(dev)
        print(f"[train] contexts {tuple(batches[0]['ctx'].shape)} f32 a step, drawn "
              f"as the train launcher draws them in {now() - t0:.1f}s")
    step_fn = make_train_step(tcfg, opt_cfg)
    ops.reset_launches()
    torch.cuda.synchronize()
    losses, step_s, metrics = [], [], []
    for b in batches:
        t0 = now()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))          # a host read: the step is done
        step_s.append(now() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = dict(ops.LAUNCHES)
    want = {**{k: 0 for k in ops.LAUNCHES},
            **{k: steps * v for k, v in step_launches(tcfg).items()}}
    peak = torch.cuda.max_memory_allocated()
    READINGS[("train_peak", cfg.name, n_layers)] = peak
    steady = step_s[1:] or step_s
    step_ms = 1e3 * sum(steady) / len(steady)
    bound, by, flop, f32_flop = _step_bound(tcfg, batch, seq, n_params)
    print(f"[train] {steps} steps: losses {losses}, grad_norm "
          f"{[round(m['grad_norm'], 4) for m in metrics]}, lr "
          f"{[m['lr'] for m in metrics]}")
    print(f"[train] step ms (host clock, ending on a host read of the loss) "
          f"{[round(1e3 * t, 2) for t in step_s]}; steady (steps 2-{steps}) "
          f"{step_ms:.2f} ms/step, {batch * seq / (step_ms / 1e3):.1f} tok/s; peak "
          f"device memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); bound "
          f"{bound:.2f} ms ({by}: {flop:.3e} bf16 FLOP at 989 TFLOP/s, "
          f"{f32_flop:.3e} f32 FLOP of the SSD at 67 TFLOP/s, or "
          f"{32 * n_params / 1e9:.1f} GB of state at 3.35 TB/s), "
          f"{step_ms / bound:.2f}x the bound")
    print(f"[train] launches {launches} (expected {steps} x step_launches: {want})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses not finite: {losses}")
    if launches != want:
        raise AssertionError(f"train path launches {launches}, expected {want}")
    with torch.no_grad():
        after = float(lm.forward_train(state.params, batches[0]["tokens"], tcfg,
                                       batches[0].get("ctx")))
    print(f"[train] loss on the first batch: {losses[0]:.4f} at the start, "
          f"{after:.4f} after {steps} steps")
    if falling:
        if not after < losses[0]:
            raise AssertionError(f"{tcfg.name}: the loss did not fall: {losses[0]} "
                                 f"-> {after}")
    # one step traced: device ms by kernel, forward and backward apart, and
    # by sublayer
    def step_once():
        nonlocal state
        state, m = step_fn(state, batches[0])
        m["loss"].item()
    tr = _trace(step_once, 1)
    _print_trace(tr, 1, f"{tcfg.name} train step (batch {batch} x {seq})")
    _split(tr, tcfg, 1, f"{tcfg.name} train step")
    # the embedding's gradient, taken twice: its backward is an indexed
    # accumulate (aten index_put_ with accumulate=True)
    emb = state.params["embed"]
    w = torch.randn((batch, seq, cfg.d_model), generator=torch.Generator(dev).manual_seed(1),
                    device=dev).to(emb.dtype)
    g1, g2 = (torch.autograd.grad((emb[batches[0]["tokens"]] * w).sum(), emb)[0]
              for _ in range(2))
    print(f"[train] embedding gradient ({batch}x{seq} tokens into "
          f"{tuple(emb.shape)} bf16, IndexBackward: index_put_ with "
          f"accumulate=True), same bits twice: {bool(torch.equal(g1, g2))}")
    # one more step, split at a synchronise: the gradient (forward, remat and
    # backward) and the AdamW update (plain torch), each on the host clock
    del g1, g2, emb
    torch.cuda.synchronize()
    t0 = now()
    _, grads = loss_and_grads(state.params, batches[1]["tokens"], tcfg,
                              batches[1].get("ctx"))
    torch.cuda.synchronize()
    t1 = now()
    adamw_update(state.params, grads, state.opt, opt_cfg)
    torch.cuda.synchronize()
    t2 = now()
    # the update's floor: each gradient read, each parameter written, and its
    # m, v and master read and written, once
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    moved = nbytes(grads) + nbytes(state.params) + 2 * nbytes(state.opt["params"])
    upd_bound, _ = _ms_bound(moved, 0, "f32")
    print(f"[train] one step split at a synchronise: gradient {1e3 * (t1 - t0):.2f} ms "
          f"(forward, remat and backward), AdamW update {1e3 * (t2 - t1):.2f} ms "
          f"against its bound {upd_bound:.2f} ms ({moved / 1e9:.2f} GB at 3.35 TB/s), "
          f"{1e3 * (t2 - t1) / upd_bound:.2f}x")
    del state, grads, batches
    torch.cuda.empty_cache()
    return launches


def _phi3_path(dev, n_layers: int = 2, prompt: int = 512, batch: int = 4,
               seq: int = 1024) -> dict:
    """Phase 7b: phi3-mini-3.8b at its published width (head dim 96, the
    wgmma flash kernels) cut to ``n_layers``: one whole-prompt prefill and a
    few decode steps through the dense engine, then a cold and a warm train
    step, the launches of each exactly as counted, and a trace of a later
    step.  Returns the launches of the prefill's run and the first step's."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.params import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    from repro_torch.testing.timing import now
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.trainer import (init_train_state, serve_launches,
                                           step_launches)

    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=n_layers)
    L, D = cfg.n_layers, cfg.head_dim
    print(f"[phi3] {cfg.name}: {L} layers of 32, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {D}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {str(cfg.dtype)[6:]}; flash variant at S={prompt}: "
          f"{kfa.variant(prompt, prompt, D, cfg.dtype)}, backward "
          f"{kfa.bwd_variant(seq, seq, D, cfg.dtype)}")
    gc.collect()                             # what earlier phases left in cycles
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = lm.Model(cfg, init_params(lm.model_defs(cfg),
                                      torch.Generator(dev).manual_seed(0), dev))
    engine = ServingEngine(model, ServeConfig(max_batch=1, max_seq=prompt + 64), device=dev)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, prompt)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = now()
    engine.submit(Request(rid=0, max_new_tokens=8, prompt=toks))
    done = list(engine.run())
    wall = now() - t0
    serve = dict(ops.LAUNCHES)
    tm = engine.timing
    want = serve_launches(cfg, tm["prefills"], tm["decode_steps"])
    out = done[0].out if done else []
    print(f"[phi3] dense engine: a {prompt}-token prompt, {tm['prefills']} whole-prompt "
          f"prefill ({1e3 * tm['prefill_s']:.2f} ms) and {tm['decode_steps']} decode "
          f"steps in {wall:.2f}s, tokens {out}; launches {serve} (expected {want})")
    if not 1 <= len(out) <= 8 or max(out) >= cfg.vocab_size or tm["prefills"] != 1:
        raise AssertionError(f"phi3 serve: tokens {out}, prefills {tm['prefills']}")
    if serve != want:
        raise AssertionError(f"phi3 serve launches {serve}, expected {want}")
    del engine, model
    torch.cuda.empty_cache()
    opt_cfg = OptConfig()
    state = init_train_state(cfg, opt_cfg, torch.Generator(dev).manual_seed(0), dev)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch, seed=0))
    tokens = torch.from_numpy(corpus.batch(0)).to(dev, torch.int64)
    step_fn = make_train_step(cfg, opt_cfg)
    want = {**{k: 0 for k in ops.LAUNCHES}, **step_launches(cfg)}
    runs = []
    for which in ("cold (the first: builds and allocations included)", "warm"):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = now()
        state, m = step_fn(state, {"tokens": tokens})
        loss = float(m["loss"])              # a host read: the step is done
        step_s = now() - t0
        runs.append(dict(ops.LAUNCHES))
        print(f"[phi3] train step at batch {batch} x {seq} (remat {cfg.remat}), {which}: "
              f"loss {loss:.4f}, grad_norm {float(m['grad_norm']):.4f}, "
              f"{1e3 * step_s:.2f} ms on the host clock; launches {runs[-1]}")
        if not math.isfinite(loss):
            raise AssertionError(f"phi3 train loss not finite: {loss}")
        if runs[-1] != want:
            raise AssertionError(f"phi3 train launches {runs[-1]}, expected {want}")
    print(f"[phi3] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above the "
          f"{base / 1e9:.2f} GB live when the phase began; launches of each step "
          f"as expected (step_launches: {want})")

    # a later step traced: the flash kernels' device ms a step, by variant
    def step_once():
        nonlocal state
        state, m = step_fn(state, {"tokens": tokens})
        m["loss"].item()
    tr = _trace(step_once, 1)
    _print_trace(tr, 1, f"phi3 train step (batch {batch} x {seq})")
    flash = {fam[:-len(" (port)")]: t / 1e3 for fam, (_, t) in tr["by"]
             if fam.startswith("flash_attention")}
    print(f"[phi3] flash device ms a train step: " + ", ".join(
        f"{fam} {ms:.3f}" for fam, ms in flash.items()))
    del state, tokens
    torch.cuda.empty_cache()
    return {"phi3_serve": serve, "phi3_train": runs[0]}


def _routing_diff(r_gpu, r_cpu, k: int) -> tuple[list, set]:
    """Rows whose routing (top-k experts, buffer slots) differs between the
    card and the CPU, each with the CPU's gap between its k-th and (k+1)-th
    logit and the most the two sides' logits differ on that row; and the
    rows a flip explains.  A flip is a tie within rounding when its gap is
    at most twice that difference (each logit moved by at most it); the
    rows after a tied row in the same expert shift their slots with it."""
    import torch

    idx_g, idx_c = r_gpu.idx.cpu(), r_cpu.idx
    lg_gpu, lg_cpu = r_gpu.logits.cpu(), r_cpu.logits
    flips = (idx_g != idx_c).any(-1)
    moved = (r_gpu.slots.cpu() != r_cpu.slots).any(0)
    top = torch.topk(lg_cpu, k + 1, dim=-1).values        # E > k experts
    rows = []
    for n in torch.nonzero(flips | moved)[:, 0].tolist():
        gap = float(top[n, k - 1] - top[n, k])
        delta = float((lg_gpu[n] - lg_cpu[n]).abs().max())
        rows.append({"row": n, "card": idx_g[n].tolist(), "cpu": idx_c[n].tolist(),
                     "flip": bool(flips[n]), "gap": gap, "delta": delta,
                     "tie": bool(flips[n]) and gap <= 2 * delta})
    return rows, {r["row"] for r in rows}


def _drops(r) -> list:
    """(row, expert) pairs past an expert's capacity."""
    import torch

    chosen = torch.zeros_like(r.slots).scatter_(0, r.idx.T, 1) > 0
    return [(n, j) for j, n in torch.nonzero(chosen & (r.slots == r.capacity)).tolist()]


def _moe_sublayer_check(sp, x, cfg, what: str) -> None:
    """One full-width MoE sublayer on the card and the same bf16 weights and
    input on the CPU: the output within the bf16 matmul limits
    (``kernel_checks.moe_tol``: ``MATMUL_TOL`` over the element and its
    row's addends) and the routing decisions (each row's experts and buffer
    slots) equal.  Every routing difference is printed with its logit gap,
    and the dropped pairs of both sides.  A difference that a tie within
    rounding does not explain fails; rows a tie explains are left out of
    the element check and printed."""
    from repro_torch.models import layers as Lyr
    from repro_torch.params import tree_map
    from repro_torch.testing import kernel_checks as kc

    sp_cpu = tree_map(lambda t: t.cpu(), sp)
    out, routes = {}, {}
    for where, p, xx in (("card", sp, x), ("cpu", sp_cpu, x.cpu())):
        out[where] = Lyr.moe_layer(p, xx, cfg).reshape(-1, cfg.d_model)
        routes[where] = Lyr.moe_route(p, Lyr.rmsnorm(xx, p["norm"], cfg.norm_eps), cfg)
    rg, rc = routes["card"], routes["cpu"]
    rows, skip = _routing_diff(rg, rc, cfg.experts_per_token)
    keep = [n for n in range(out["cpu"].shape[0]) if n not in skip]
    rtol, atol = kc.moe_tol(sp_cpu, x.cpu(), cfg)
    res = kc.compare(out["card"].cpu()[keep], out["cpu"][keep], (rtol, atol[keep]))
    drops = {w: _drops(r) for w, r in routes.items()}
    print(f"[moe] sublayer vs CPU, {what}: {out['cpu'].shape[0]} rows, C = {rc.capacity}; "
          f"{_reading(res)} (atol {float(atol.min()):.1e}-{float(atol.max()):.1e} "
          f"by row: moe_tol); routing differs on {len(rows)} rows "
          f"({sum(r['flip'] for r in rows)} top-k flips, {sum(r['tie'] for r in rows)} "
          f"ties within rounding); dropped pairs card {len(drops['card'])}, "
          f"CPU {len(drops['cpu'])}, equal: {drops['card'] == drops['cpu']}")
    for w in ("card", "cpu"):
        print(f"[moe]   dropped (row, expert) on the {w}: {drops[w][:32]}"
              f"{' ...' if len(drops[w]) > 32 else ''}")
    for r in rows:
        print(f"[moe]   row {r['row']}: experts card {r['card']} cpu {r['cpu']}, "
              f"CPU gap k-th to next {r['gap']:.3e}, logits differ by at most "
              f"{r['delta']:.3e}{' (a tie within rounding)' if r['tie'] else ''}")
    if not res["ok"]:
        raise AssertionError(f"MoE sublayer ({what}) differs from the CPU: {res}")
    flips = [r for r in rows if r["flip"]]
    if any(not r["tie"] for r in flips) or (rows and not flips):
        raise AssertionError(f"MoE routing ({what}) differs from the CPU: {rows}")


def _moe_path(dev, n_layers: int = 24) -> dict:
    """Phase 8: the MoE family.  The smoke MoE models (f32) card against
    CPU, dense for both and paged (whole-prompt, 128-token chunks, two
    pods) for qwen3-moe (mixtral is windowed: the paged engine refuses
    it); then mixtral-8x7b at its published width cut to ``n_layers`` of
    32 (bf16, seeded weights) serving 8 requests through ``ServingEngine``,
    one prompt past the 4,096-token window; launches exactly
    ``serve_launches``; traces of decode steps and of two whole-prompt
    prefills, each split by sublayer; one full-width MoE sublayer held to
    the CPU path.  Returns the serving run's launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.testing.timing import now
    from repro_torch.train.trainer import serve_launches

    for name in ("qwen3-moe-235b-a22b", "mixtral-8x7b"):
        scfg = get_smoke_config(name)
        cpu_params = init_params(lm.model_defs(scfg),
                                 torch.Generator().manual_seed(0), "cpu")
        gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
        _smoke_dense(scfg, cpu_params, gpu_params, dev)
        if not scfg.window:
            _smoke_paged(scfg, cpu_params, gpu_params, dev, chunk=128, max_seq=128)

    gc.collect()                             # what earlier phases left in cycles
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    print(f"[moe] torch.cuda.memory_allocated() {base / 1e9:.2f} GB when the "
          f"full-width part began (the earlier phases' models freed)")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=n_layers)
    t0 = now()
    model = lm.Model(cfg, init_params(lm.model_defs(cfg),
                                      torch.Generator(dev).manual_seed(0), dev))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    W = kc.MIXTRAL_WINDOW
    max_seq = kc.MIXTRAL_LONG + 512
    print(f"[moe] {cfg.name}: {cfg.n_layers} layers of 32, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_experts} "
          f"experts of d_ff {cfg.d_ff_expert}, top-{cfg.experts_per_token}, capacity "
          f"factor {cfg.capacity_factor}, window {cfg.window}, {str(cfg.dtype)[6:]}; "
          f"{n_bytes / 1e9:.2f} GB of weights, drawn in {now() - t0:.1f}s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB while drawing")
    engine = ServingEngine(model, ServeConfig(max_batch=4, max_seq=max_seq), device=dev)
    rng = np.random.default_rng(0)
    plens = [int(n) for n in rng.integers(32, 257, 8)]      # phase 5's lengths
    plens[1] = kc.MIXTRAL_LONG                              # one past the window
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in plens]
    ops.reset_launches()
    torch.cuda.synchronize()
    t_start = now()
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, max_new_tokens=16, prompt=prompt))
    done = list(engine.run())
    wall = now() - t_start
    launches = dict(ops.LAUNCHES)
    tm = engine.timing
    want = serve_launches(cfg, tm["prefills"], tm["decode_steps"])
    ttft = [r.t_first - r.t_submit for r in done]
    prompt_toks = sum(plens)
    decode_toks = sum(len(r.out) - 1 for r in done)
    print(f"[moe] {len(done)} of 8 requests finished, prompts {plens} (ring W = "
          f"{W}, max_seq {max_seq}, batch 4), {sum(len(r.out) for r in done)} tokens "
          f"generated, {tm['prefills']} prefills + {tm['decode_steps']} decode steps "
          f"in {wall:.2f}s")
    print(f"[moe] prefill {prompt_toks / tm['prefill_s']:.1f} tok/s ({prompt_toks} "
          f"tokens in {tm['prefill_s']:.3f}s); decode {decode_toks / tm['decode_s']:.1f} "
          f"tok/s, {1e3 * tm['decode_s'] / tm['decode_steps']:.2f} ms/step; p50 TTFT "
          f"{1e3 * float(np.median(ttft)):.1f} ms (all 8 submitted at once, 4 slots); "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"[moe] launches {launches} (expected {want})")
    if len(done) != 8 or any(not r.out or max(r.out) >= cfg.vocab_size for r in done):
        raise AssertionError(f"mixtral: not every request finished in the vocabulary")
    if not any(len(r.prompt) == kc.MIXTRAL_LONG for r in done):
        raise AssertionError("mixtral: the prompt past the window did not finish")
    if launches != want:
        raise AssertionError(f"mixtral launches {launches}, expected {want}")

    # where a decode step's device time goes: 4 fresh requests fill the slots
    n_trace = 4
    for rid, prompt in enumerate(prompts[2:6]):
        engine.submit(Request(rid=100 + rid, max_new_tokens=3 * n_trace + 4,
                              prompt=prompt))
    engine.step()
    tr = _trace(engine.step, n_trace)
    _print_trace(tr, n_trace, "mixtral decode steps at batch 4")
    _split(tr, cfg, n_trace, "mixtral decode at batch 4")
    engine.run()
    params = engine.params
    # whole-prompt prefills: 223 tokens, and 4,608 past the window (the
    # windowed flash kernel, once a layer a prefill)
    for i, steps in ((0, 2), (1, 1)):
        toks = torch.as_tensor(prompts[i], device=dev)[None]

        def prefill_once():
            _, lg = lm.prefill(params, toks, cfg, max_seq)
            lg[0, -1, 0].item()              # a host read, as the engine's
        ops.reset_launches()
        tr = _trace(prefill_once, steps)
        _print_trace(tr, steps, f"mixtral whole-prompt prefills of {plens[i]} tokens")
        _split(tr, cfg, steps, f"mixtral prefill of {plens[i]} tokens")
        flash = ops.LAUNCHES["flash_attention"]
        variant = kfa.variant(plens[i], plens[i], cfg.head_dim, cfg.dtype)
        print(f"[moe] prefill of {plens[i]} tokens: flash attention {variant}, "
              f"window {cfg.window}, {flash} launches over {3 * steps} prefills")
        if flash != 3 * steps * cfg.n_layers or variant != "wgmma":
            raise AssertionError(f"mixtral prefill of {plens[i]}: flash launches "
                                 f"{flash}, variant {variant}")

    # one full-width MoE sublayer (the first layer's) against the CPU path
    sp = tree_map(lambda t: t[0], params["period"]["l0"]["s1_moe"])
    for what, toks in (("a 223-token prefill", prompts[0][None]),
                       ("a batch-4 decode step", rng.integers(1, cfg.vocab_size, (4, 1)))):
        _moe_sublayer_check(sp, params["embed"][torch.as_tensor(toks, device=dev)],
                            cfg, what)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[moe] on {smi.splitlines()[0]}")
    del engine, model, params, sp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: the MoE sublayer's gradients, card against CPU, each leaf held to
#: ``|d| <= MOE_GRAD_RTOL (|want| + max|want|)``: one bf16 ulp of the element
#: (x's gradient and the expert weights' are bf16, each the sum of products
#: of bf16 operands in another order) and one of the leaf's largest element,
#: for what one-ulp differences in the bf16 intermediates (the products'
#: outputs, h, the gathered rows) carry into every element they feed; the
#: router's f32 gradient takes the same limit, its terms coming from the
#: bf16 experts' outputs
MOE_GRAD_RTOL = 8e-3
#: the short input of the MoE sublayer's gradient check: 128 tokens, C = 40
#: buffer rows an expert (top-2 of 8 at factor 1.25)
MOE_GRAD_TOKENS = 128


def _moe_grad_check(sp, x, cfg) -> None:
    """One full-width MoE sublayer's gradients on the card and on the CPU,
    from the same bf16 weights and input: the loss sum(y * w) for a seeded
    f32 w; the gradients of x, the router and the busiest expert's wi, wg
    and wo within ``MOE_GRAD_RTOL``; the routing (each row's experts and
    slots) the same on both sides, with no tie; and the card's gradients
    the same bits twice."""
    import torch

    from repro_torch.models import layers as Lyr
    from repro_torch.params import tree_map
    from repro_torch.testing import kernel_checks as kc

    names = ("x", "router", "wi", "wg", "wo")
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    got = {}
    for where, dev in (("card", x.device), ("card again", x.device), ("cpu", "cpu")):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), sp)
        xx = x.detach().to(dev).requires_grad_(True)
        y = Lyr.moe_layer(p, xx, cfg)
        loss = (y.float() * w.to(dev)).sum()
        got[where] = torch.autograd.grad(loss, [xx] + [p[k] for k in names[1:]])
        with torch.no_grad():
            route = Lyr.moe_route(p, Lyr.rmsnorm(xx, p["norm"], cfg.norm_eps), cfg)
        got[where + " route"] = route
    rows, _ = _routing_diff(got["card route"], got["cpu route"], cfg.experts_per_token)
    counts = (got["cpu route"].slots < got["cpu route"].capacity).sum(dim=1)
    j = int(torch.argmax(counts))
    same = all(torch.equal(a, b) for a, b in zip(got["card"], got["card again"]))
    res = {}
    for i, name in enumerate(names):
        g, want = got["card"][i].cpu(), got["cpu"][i]
        if name in ("wi", "wg", "wo"):
            g, want = g[j], want[j]
        res[name] = kc.compare(g, want, (MOE_GRAD_RTOL,
                                         MOE_GRAD_RTOL * want.abs().max().float()))
    print(f"[moe-train] MoE sublayer gradients vs CPU, {x.shape[1]} tokens, C = "
          f"{got['cpu route'].capacity}, expert {j} ({int(counts[j])} rows): " + "; ".join(
              f"d{n} limit_use {r['limit_use']:.3f} max_abs_err {r['max_abs_err']:.2e}"
              for n, r in res.items())
          + f" (|err| <= {MOE_GRAD_RTOL:.0e} (|cpu| + max|cpu|)); routing differs on "
          f"{len(rows)} rows; the card's gradients the same bits twice: {same}")
    if rows or not same or not all(r["ok"] for r in res.values()):
        raise AssertionError(f"MoE sublayer gradients differ: {rows} {same} {res}")


def _moe_train_path(dev, n_layers: int = 2) -> dict:
    """Phase 8's training part: mixtral-8x7b at its published width cut to
    ``n_layers`` of 32 (bf16, seeded weights, remat), 3 train steps at batch
    4 x 1024 (C = 1,280 rows an expert) through ``_train_path`` with
    phase 7's ``OptConfig`` defaults, launches
    exactly ``step_launches``, a traced step split forward and backward by
    sublayer; then one full-width MoE sublayer's gradients held to the CPU
    path (``_moe_grad_check``).  Returns the steps' launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers as Lyr
    from repro_torch.models import lm
    from repro_torch.params import init_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("mixtral-8x7b")
    print(f"[moe-train] {cfg.name}: {n_layers} of 32 layers, C = "
          f"{Lyr.moe_capacity(cfg, 4 * 1024)} rows an expert at 4 x 1024 tokens; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB live when the phase began")
    launches = _train_path(cfg, dev, n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    # one full-width MoE sublayer's gradients against the CPU's
    one = dataclasses.replace(cfg, n_layers=1)
    sp = init_params(Lyr.moe_defs(one), torch.Generator(dev).manual_seed(1), dev)
    emb = init_params({"embed": lm.model_defs(one)["embed"]},
                      torch.Generator(dev).manual_seed(2), dev)["embed"]
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (1, MOE_GRAD_TOKENS))
    _moe_grad_check(sp, emb[torch.as_tensor(toks, device=dev)], one)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[moe-train] on {smi.splitlines()[0]}")
    del sp, emb
    torch.cuda.empty_cache()
    return launches


#: the long prompt of phase 9's serving run: 18 SSD chunks of 256
MAMBA_LONG = 4608


def _ssm_smoke(dev) -> None:
    """Phase 5's Mamba part: the mamba2-370m and jamba smoke models (f32,
    seeded weights) through the kernel path on the card and the plain path
    on the CPU, logits and the dense engine's greedy streams
    (``_smoke_dense``; the paged engine refuses a Mamba state)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map

    for name in ("mamba2-370m", "jamba-1.5-large-398b"):
        scfg = get_smoke_config(name)
        cpu_params = init_params(lm.model_defs(scfg),
                                 torch.Generator().manual_seed(0), "cpu")
        _smoke_dense(scfg, cpu_params, tree_map(lambda t: t.to(dev), cpu_params), dev)


def _mamba_sublayer_check(sp, x, cfg, what: str, conv=None, state=None) -> None:
    """One full-width Mamba sublayer on the card and on the CPU, the same
    bf16 weights, input and carried states: its output, conv window and SSM
    state within ``kernel_checks.mamba_tol``.  Without ``conv`` and
    ``state`` a whole prompt through ``mamba_layer``; with them a decode
    step through ``mamba_layer_decode`` from that cache."""
    from repro_torch.models import layers as Lyr
    from repro_torch.params import tree_map
    from repro_torch.testing import kernel_checks as kc

    sp_cpu = tree_map(lambda t: t.cpu(), sp)
    outs = {}
    for where, p, xx in (("card", sp, x), ("cpu", sp_cpu, x.cpu())):
        if conv is None:
            y, (c, st) = Lyr.mamba_layer(p, xx, cfg, return_state=True)
        else:
            cache = Lyr.MambaCache(conv.to(xx.device).clone(), state.to(xx.device).clone())
            y, cache = Lyr.mamba_layer_decode(p, xx, cache, cfg)
            c, st = cache.conv, cache.state
        outs[where] = (y.reshape(-1, cfg.d_model), c, st)
    tol = kc.mamba_tol(sp_cpu, x.cpu(), cfg, None if conv is None else conv.cpu(),
                       None if state is None else state.cpu())
    res = {n: kc.compare(g.cpu(), w, tol[n])
           for n, g, w in zip(("out", "conv", "state"), outs["card"], outs["cpu"])}
    print(f"[ssm] Mamba sublayer vs CPU, {what}: " + "; ".join(
        f"{n} {tuple(outs['cpu'][i].shape)} {_reading(r)}"
        for i, (n, r) in enumerate(res.items()))
        + " (kernel_checks.mamba_tol: atol by row for out, by element for state)")
    if not all(r["ok"] for r in res.values()):
        raise AssertionError(f"Mamba sublayer ({what}) differs from the CPU: {res}")


def _ssm_path(dev) -> dict:
    """Phase 9: mamba2-370m at its published width and depth (48 layers,
    bf16, seeded weights).  Serving: 8 requests through ``ServingEngine`` at
    batch 4 (one prompt of ``MAMBA_LONG`` tokens, seven of phase 5's
    lengths, 16 new each), launches exactly ``serve_launches``; traces of
    decode steps and of whole-prompt prefills split by sublayer and kernel
    class (``_split``); one full-width Mamba sublayer held to the CPU path
    at two prefills and a decode step.  Training: 3 steps at batch 4 x
    1024 under remat (``_train_path``), launches exactly
    ``step_launches``, the loss falling.  Returns the launches of both."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as Lyr
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    from repro_torch.testing.timing import now
    from repro_torch.train import OptConfig
    from repro_torch.train.trainer import serve_launches

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mamba2-370m")
    t0 = now()
    model = lm.Model(cfg, init_params(lm.model_defs(cfg),
                                      torch.Generator(dev).manual_seed(0), dev))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    print(f"[ssm] {cfg.name}: {cfg.n_layers} layers (full depth), d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner_ssm}, state {cfg.ssm_state}, "
          f"{cfg.n_ssm_heads} SSD heads of {cfg.ssm_head_dim}, conv {cfg.ssm_conv}, "
          f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size} (tied), "
          f"{str(cfg.dtype)[6:]}; {cfg.n_params() / 1e6:.1f} M params, "
          f"{n_bytes / 1e9:.3f} GB of weights, drawn in {now() - t0:.1f}s")
    max_seq = MAMBA_LONG + 512
    engine = ServingEngine(model, ServeConfig(max_batch=4, max_seq=max_seq), device=dev)
    rng = np.random.default_rng(0)
    plens = [int(n) for n in rng.integers(32, 257, 8)]      # phase 5's lengths
    plens[1] = MAMBA_LONG
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in plens]
    ops.reset_launches()
    torch.cuda.synchronize()
    t_start = now()
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, max_new_tokens=16, prompt=prompt))
    done = list(engine.run())
    wall = now() - t_start
    launches = dict(ops.LAUNCHES)
    tm = engine.timing
    want = serve_launches(cfg, tm["prefills"], tm["decode_steps"])
    ttft = [r.t_first - r.t_submit for r in done]
    prompt_toks = sum(plens)
    decode_toks = sum(len(r.out) - 1 for r in done)
    print(f"[ssm] {len(done)} of 8 requests finished, prompts {plens} (batch 4, "
          f"max_seq {max_seq}), {sum(len(r.out) for r in done)} tokens generated, "
          f"{tm['prefills']} prefills + {tm['decode_steps']} decode steps in {wall:.2f}s")
    print(f"[ssm] prefill {prompt_toks / tm['prefill_s']:.1f} tok/s ({prompt_toks} "
          f"tokens in {tm['prefill_s']:.3f}s); decode {decode_toks / tm['decode_s']:.1f} "
          f"tok/s, {1e3 * tm['decode_s'] / tm['decode_steps']:.2f} ms/step; p50 TTFT "
          f"{1e3 * float(np.median(ttft)):.1f} ms (all 8 submitted at once, 4 slots); "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"[ssm] launches {launches} (expected {want})")
    if len(done) != 8 or any(not r.out or max(r.out) >= cfg.vocab_size for r in done):
        raise AssertionError("mamba2: not every request finished in the vocabulary")
    if launches != want:
        raise AssertionError(f"mamba2 launches {launches}, expected {want}")

    # where a decode step's device time goes: 4 fresh requests fill the slots
    n_trace = 4
    for rid, prompt in enumerate(prompts[2:6]):
        engine.submit(Request(rid=100 + rid, max_new_tokens=3 * n_trace + 4,
                              prompt=prompt))
    engine.step()
    tr = _trace(engine.step, n_trace)
    _print_trace(tr, n_trace, "mamba2 decode steps at batch 4")
    _split(tr, cfg, n_trace, "mamba2 decode at batch 4")
    engine.run()
    params = engine.params
    # whole-prompt prefills: 223 tokens (one chunk) and MAMBA_LONG (18)
    for i, steps in ((0, 2), (1, 1)):
        toks = torch.as_tensor(prompts[i], device=dev)[None]

        def prefill_once():
            _, lg = lm.prefill(params, toks, cfg, max_seq)
            lg[0, -1, 0].item()              # a host read, as the engine's
        tr = _trace(prefill_once, steps)
        _print_trace(tr, steps, f"mamba2 whole-prompt prefills of {plens[i]} tokens")
        _split(tr, cfg, steps, f"mamba2 prefill of {plens[i]} tokens")

    # one full-width Mamba sublayer (the first layer's) against the CPU path
    sp = tree_map(lambda t: t[0], params["period"]["l0"]["s0_mamba"])
    for i in (0, 1):
        x = params["embed"][torch.as_tensor(prompts[i], device=dev)[None]]
        _mamba_sublayer_check(sp, x, cfg, f"a {plens[i]}-token prefill")
    _, (conv, state) = Lyr.mamba_layer(tree_map(lambda t: t.cpu(), sp), x.cpu(), cfg,
                                       return_state=True)
    xt = params["embed"][torch.as_tensor(rng.integers(1, cfg.vocab_size, (4, 1)),
                                         device=dev)]
    _mamba_sublayer_check(sp, xt, cfg, f"a batch-4 decode step after the "
                          f"{plens[1]}-token prompt", conv.expand(4, -1, -1),
                          state.expand(4, -1, -1, -1))
    del engine, model, params, sp
    gc.collect()
    torch.cuda.empty_cache()
    # training: the full model, 3 steps at 4 x 1024
    train = _train_path(cfg, dev, n_layers=cfg.n_layers,
                        opt_cfg=OptConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                        falling=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[ssm] on {smi.splitlines()[0]}")
    return {"ssm_serve": launches, "ssm_train": train}


# -- phase 10: the cross-attention families ------------------------------------

#: the cross-attention sublayer's gradients, card against CPU, each leaf held
#: to ``|d| <= XATTN_GRAD_RTOL (|want| + max|want|)``, as the MoE sublayer's
#: (``MOE_GRAD_RTOL``): one bf16 ulp of the element (each gradient is a sum of
#: products of bf16 operands, in another order) and one of the leaf's largest
#: element, for what one-ulp differences in the bf16 intermediates (q, the
#: context's K and V, the attention's output and its gradient) carry into
#: every element they feed
XATTN_GRAD_RTOL = 8e-3
#: the gradient check's tokens, against a whole context
XATTN_GRAD_TOKENS = 128
#: llama-3.2-vision-11b's training cut: periods of its 8 (5 layers each, one
#: of them cross-attention) that fit the card beside their optimizer state
VLM_TRAIN_PERIODS = 2
#: phase 6's cross-attention rows, (name, B, S, Sk, Hq, Hkv, D), non-causal
XATTN_TIMED = (("vlm cross", 4, 1024, 6404, 32, 8, 128),
               ("seamless cross", 4, 1024, 256, 16, 16, 64),
               ("seamless encoder", 4, 256, 256, 16, 16, 64))


def _xattn_checks(kc, kfa, kmm) -> tuple[dict, list]:
    """Phases 3 and 3c at the cross-attention families' shapes, each call
    twice for the same bits, one line a case: flash attention forward and
    backward, non-causal, no window, at ``kernel_checks.XATTN_FLASH_CASES``
    (Sk != S, and the encoder's S = Sk) in bf16 and f32, bf16 at the head
    dims 64 and 128 taking wgmma forward and the rule's tensor-core
    backward (stats over 6,404 keys, with the forward's statistics held to
    the plain L and f32 output; wgmma below ``STATS_MIN_SK``), f32 there
    tf32x3 both ways, the smoke heads simt; the stats backward forced at
    ``kernel_checks.STATS_FLASH_CASES`` (causal, windowed, every head dim,
    the training shapes); the matmul at ``XATTN_MATMUL`` forward and at
    ``XATTN_MATMUL_BWD`` dX and dW; rmsnorm at seamless's width.  Returns
    the largest errors and the failed cases."""
    import torch

    errs, failed = {}, []
    dts = (torch.bfloat16, torch.float32)

    def note(key, r, line, bad=False):
        errs[key] = r["max_abs_err"]
        parts = " ".join(f"{k} {v['limit_use']:.3f}" for k, v in r.get("parts", {}).items())
        print(f"[check] {line} same bits twice: {r['same_bits']} {_reading(r)}"
              + (f" (limit use {parts})" if parts else ""))
        if not r["ok"] or bad:
            failed.append(key)

    for name, B, S, Sk, Hq, Hkv, D in kc.XATTN_FLASH_CASES:
        for dt in dts:
            r = kc.check_flash_cross(B, S, Sk, Hq, Hkv, D, dt)
            # f32 on the TF32 kernels where the tree has them (an older tree,
            # where this file is copied for an A/B, takes simt)
            tc = {torch.bfloat16: "wgmma",
                  torch.float32: "tf32x3" if "tf32x3" in kfa.VARIANTS else "simt"}
            want = tc[dt] if D in kfa.WGMMA_HEAD_DIMS else "simt"
            # (a tree before the stats backward, where this file is copied
            # for an A/B, has no STATS_MIN_SK)
            min_sk = getattr(kfa, "STATS_MIN_SK", None)
            want_bwd = "stats" if want == "wgmma" and min_sk and Sk >= min_sk else want
            note(("flash_attention cross", name, dt), r,
                 f"flash_attention cross fwd+bwd {name}: B={B} Hq={Hq} Hkv={Hkv} D={D} "
                 f"S={S} Sk={Sk} full window=None {str(dt)[6:]:8s} fwd {r['variant']} "
                 f"bwd {r['bwd_variant']}",
                 bad=(r["variant"], r["bwd_variant"]) != (want, want_bwd)
                 or ("stats" in r["parts"]) != (want_bwd == "stats"))
    for name, B, S, Sk, Hq, Hkv, D, causal, window in getattr(kc, "STATS_FLASH_CASES", ()):
        r = kc.check_flash_stats_bwd(B, S, Sk, Hq, Hkv, D, causal, window)
        note(("flash_attention stats", name), r,
             f"flash_attention_bwd stats forced fwd+stats+bwd {name}: B={B} Hq={Hq} "
             f"Hkv={Hkv} D={D} S={S} Sk={Sk} causal={causal} window={window} bfloat16",
             bad="stats" not in r["parts"])
    for proj, M, K, N in kc.XATTN_MATMUL:
        for dt in dts:
            r = kc.check_matmul(M, K, N, dt)
            note(("matmul xattn", proj, M, dt), r,
                 f"matmul {proj:15s} M={M:<5d} K={K:<5d} N={N:<5d} {str(dt)[6:]:8s} "
                 f"{kmm.variant(M, K, N, dt):6s}")
    for proj, M, K, N in kc.XATTN_MATMUL_BWD:
        for dt in dts:
            for which in "ab":
                r = kc.check_matmul_bwd(M, K, N, dt, which)
                note(("matmul_bwd xattn", proj, which, dt), r,
                     f"matmul_bwd d{which.upper()} {proj:18s} M={M:<5d} K={K:<5d} "
                     f"N={N:<5d} {str(dt)[6:]:8s} {r['variant']:5s}")
    for R, D in kc.XATTN_NORM:
        for dt in dts:
            r = kc.check_rmsnorm(R, D, dt)
            note(("rmsnorm xattn", R, D, dt), r, f"rmsnorm seamless R={R:<4d} D={D} "
                 f"{str(dt)[6:]:8s}")
        r = kc.check_rmsnorm_bwd(R, D, torch.bfloat16)
        note(("rmsnorm_bwd xattn", R, D), r, f"rmsnorm_bwd seamless R={R:<4d} D={D} "
             f"bfloat16 {r['path']:6s}")
    return errs, failed


def _xattn_times(kc, kfa, ref, time_ms) -> dict:
    """Phase 6, flash attention at the cross-attention families' shapes
    (``XATTN_TIMED``), bf16, non-causal: forward and backward, kernel,
    plain and library between CUDA events, device ms a call from a trace
    (``_device_call``) beside SDPA's (forward) and autograd of SDPA's
    (backward) on the same inputs, the KV heads expanded for the library
    call, and the bound: q and the output (forward; q, do, dq and k, v, dk,
    dv backward) moved once, 4 D (forward) and 10 D (backward) operations a
    (q, key) pair.  Returns rows by name, each with "fwd" and "bwd"."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for name, B, S, Sk, Hq, Hkv, D in XATTN_TIMED:
        q, k, v, do = kc.cross_inputs(B, S, Sk, Hq, Hkv, D, torch.bfloat16)
        ke, ve = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
        fk = lambda: kfa.flash_attention(q, k, v, causal=False)
        fl = lambda: F.scaled_dot_product_attention(q, ke, ve)
        pairs = B * Hq * S * Sk
        io_q, io_k = B * S * Hq * D * 2, B * Sk * Hkv * D * 2
        bound, by = _ms_bound(2 * io_q + 2 * io_k, 4.0 * D * pairs, "bf16")
        fwd = dict(ms=time_ms(fk, 20), plain_ms=time_ms(
            lambda: ref.attention(q, k, v, causal=False), 2), library_ms=time_ms(fl, 20),
            bound_ms=bound, bound_by=by, device_ms=_device_call(fk, 10),
            library_device_ms=_device_call(fl, 10), variant=kfa.variant(S, Sk, D, q.dtype),
            shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},Sk={Sk},D={D},full,bf16")
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, ke, ve))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        # a stats backward reads the statistics autograd's forward keeps (a
        # tree before them, where this file is copied for an A/B, has none)
        st = kfa._forward(q, k, v, False, None, stats=True)[1] if hasattr(kfa, "Stats") else None
        extra = {"stats": st} if st is not None else {}
        bk = lambda: kfa.backward(q, k, v, do, causal=False, **extra)
        bl = lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)
        bound, by = _ms_bound(3 * io_q + 4 * io_k, 10.0 * D * pairs, "bf16")
        bwd = dict(ms=time_ms(bk, 10), plain_ms=time_ms(
            lambda: ref.attention_bwd(q, k, v, do, causal=False), 1),
            library_ms=time_ms(bl, 10), bound_ms=bound, bound_by=by,
            device_ms=_device_call(bk, 5), library_device_ms=_device_call(bl, 5),
            variant=kfa.bwd_variant(S, Sk, D, q.dtype), shape=fwd["shape"])
        rows[name] = {"fwd": fwd, "bwd": bwd}
        for way, r, lib in (("", fwd, "SDPA"), ("_bwd", bwd, "SDPA backward (autograd)")):
            print(f"[time] flash_attention{way} {name} B={B} Hq={Hq} Hkv={Hkv} S={S} "
                  f"Sk={Sk} D={D} full bf16 {r['variant']} kernel {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  {lib} {r['library_ms']:.4f} ms  bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}); device: kernel "
                  f"{r['device_ms']:.4f} ms, {lib} {r['library_device_ms']:.4f} ms, "
                  f"{r['device_ms'] / r['library_device_ms']:.2f}x the library, "
                  f"{r['device_ms'] / r['bound_ms']:.1f}x bound")
        del q, k, v, do, ke, ve, ql, kl, vl, ol, st
    return rows


def _xattn_smoke(dev) -> None:
    """Phase 10's first part: each cross-attention smoke model (f32, the JAX
    initialiser's weights from ``testing/<arch>-smoke-jax-seed0.npz``) on the
    card through the kernels and on the CPU through the plain versions:
    ``prefill(ctx_embeds)`` and 6 greedy decode steps, the logits of each
    forward held within 1e-4 + 1e-4 |plain| (f32 on both sides, sums in
    other orders), and the two greedy streams, which must be the same."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.params import tree_map
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.testing import train_checks as tc

    for name in ("seamless-m4t-large-v2", "llama-3.2-vision-11b"):
        cfg = get_smoke_config(name)
        cpu = tc.smoke_params(name)
        card = tree_map(lambda t: t.to(dev), cpu)
        rng = np.random.default_rng(0)
        S = 19
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, S)))
        ctx = torch.from_numpy((rng.normal(size=(3, lm.context_len(cfg, S), cfg.d_ctx))
                                * 0.1).astype(np.float32))
        streams = {}
        with torch.inference_mode():
            for where, p in (("cpu", cpu), ("card", card)):
                d = "cpu" if where == "cpu" else dev
                cache, lg = lm.prefill(p, toks.to(d), cfg, 32, ctx.to(d))
                out, lgs = [], [lg.cpu()]
                for i in range(6):
                    tok = lg[:, -1].argmax(-1)[:, None]
                    out.append(tok[:, 0].tolist())
                    lg, cache = lm.decode_step(p, tok, cache, S + i, cfg)
                    lgs.append(lg.cpu())
                streams[where] = (out, lgs)
        worst = 0.0
        for a, b in zip(streams["card"][1], streams["cpu"][1]):
            r = kc.compare(a, b, (1e-4, 1e-4))
            worst = max(worst, r["limit_use"])
            if not r["ok"]:
                raise AssertionError(f"{name} smoke logits differ card vs CPU: {r}")
        same = streams["card"][0] == streams["cpu"][0]
        print(f"[xattn] {name}-smoke f32 (JAX init): prefill of {S} tokens with "
              f"{ctx.shape[1]} context tokens and 6 greedy decode steps, logits card vs "
              f"CPU limit use {worst:.3f} (|err| <= 1e-4 + 1e-4|plain|); greedy streams "
              f"equal: {same} {streams['card'][0]}")
        if not same:
            raise AssertionError(f"{name}: greedy streams differ card vs CPU")


def _xattn_sublayer_check(sp, x, ctx, cfg, what: str, cache=None) -> None:
    """One full-width cross-attention sublayer on the card and on the CPU,
    the same bf16 weights, input and context: a whole prompt through
    ``xattn_layer_prefill`` (its output and its cache, the context's K/V),
    or with ``cache`` a decode step through ``xattn_layer_decode`` over
    that cache.  Output within ``kernel_checks.xattn_tol``, K/V within
    ``MATMUL_TOL``."""
    import torch

    from repro_torch.models import layers as Lyr
    from repro_torch.params import tree_map
    from repro_torch.testing import kernel_checks as kc

    sp_cpu = tree_map(lambda t: t.cpu(), sp)
    outs = {}
    with torch.inference_mode():
        for where, p, xx, cc in (("card", sp, x, ctx), ("cpu", sp_cpu, x.cpu(), ctx.cpu())):
            if cache is None:
                y, kv = Lyr.xattn_layer_prefill(p, xx, cc, cfg)
            else:
                kv = Lyr.XAttnCache(*(t.to(xx.device) for t in cache))
                y, _ = Lyr.xattn_layer_decode(p, xx, kv, cfg)
            outs[where] = (y.reshape(-1, cfg.d_model), *kv)
        cpu_cache = None if cache is None else tuple(t.cpu() for t in cache)
        tol = kc.xattn_tol(sp_cpu, x.cpu(), ctx.cpu(), cfg, cpu_cache)
    res = {"out": kc.compare(outs["card"][0].cpu(), outs["cpu"][0], tol)}
    if cache is None:
        for i, n in ((1, "k"), (2, "v")):
            res[n] = kc.compare(outs["card"][i].cpu(), outs["cpu"][i],
                                kc.MATMUL_TOL[torch.bfloat16])
    print(f"[xattn] cross-attention sublayer vs CPU, {what}: " + "; ".join(
        f"{n} {tuple(outs['cpu'][i].shape)} {_reading(r)}" for i, (n, r) in
        enumerate(res.items())) + " (out: kernel_checks.xattn_tol, atol by row)")
    if not all(r["ok"] for r in res.values()):
        raise AssertionError(f"cross-attention sublayer ({what}) differs: {res}")


def _xsplit(tr: dict, labels: list, steps: int, what: str) -> None:
    """A traced serving forward split by sublayer in launch order.
    ``labels`` are (label, port products) of one forward's segments: what
    runs before the first port rmsnorm, then one segment a norm opens (the
    sublayers in order, the final norm and head last; a later step's
    kernels before its first norm count to the head before them).  A trace
    can miss kernels, most often at its start, so the segments take their
    labels from the trace's end backwards: a segment that holds its
    label's products and the one before's is two sublayers whose second
    norm the trace missed (its kernels count to the first), any other
    count is a segment off, after which the labels skip one where that
    fits the next four segments' products better (a norm and a product
    missed together); the split stands with at most two of each a step.  Device ms a step by label and kernel class: the port's products,
    norms and attention, and plain torch (the context's cast and
    ``ctx_proj``, RoPE, a decode step's attention einsums, adds)."""
    if not tr["events"]:
        print(f"[split] {what}: the profiler recorded no device activity: not measured")
        return
    port = lambda fam: fam.endswith("(port)")
    segs = [[]]
    for fam, us in tr["seq"]:
        if port(fam) and fam.startswith("rmsnorm"):
            segs.append([])
        segs[-1].append((fam, us))
    n = len(labels) - 1                  # norms a forward
    prev = lambda j: j - 1 if j > 1 else n
    mms = [sum(port(fam) and fam.startswith("matmul") for fam, _ in seg) for seg in segs]

    def fits(k, j):                      # segments k-1 .. k-4 against the labels before j
        hits = 0
        for kk in range(k - 1, max(k - 5, 0), -1):
            j = prev(j)
            hits += mms[kk] == labels[j][1]
        return hits

    rows, j, merged, off = {}, n, 0, 0
    for k in range(len(segs) - 1, -1, -1):
        mm = mms[k]
        if k == 0:
            j = 0                        # before the trace's first norm
        elif mm == labels[prev(j)][1] + labels[j][1] != labels[j][1]:
            merged, j = merged + 1, prev(j)
        elif mm != labels[j][1]:
            off += 1
            if fits(k, prev(j)) > fits(k, j):
                merged, j = merged + 1, prev(j)
        row = rows.setdefault(labels[j][0], {})
        for fam, us in segs[k]:
            cls = ("plain torch" if not port(fam) else "products"
                   if fam.startswith("matmul") else "norms"
                   if fam.startswith("rmsnorm") else "attention")
            row[cls] = row.get(cls, 0.0) + us / 1e3 / steps
        j = prev(j)
    if merged > 2 * steps or off > 2 * steps:
        print(f"[split] {what}: {len(segs)} segments, {merged} of them two sublayers "
              f"and {off} with another count of products than their label's: not split; "
              f"products a segment {''.join(str(min(m, 9)) for m in mms)}, a forward's "
              f"{''.join(str(p) for _, p in labels)}")
        return
    print(f"[split] {what}: {len(segs)} segments, {merged} of them two sublayers (a "
          f"norm the trace missed), {off} with another count of products")
    for label in dict.fromkeys(lb for lb, _ in labels):
        if label in rows:
            row = rows[label]
            print(f"[split] {what}, {label}: " + ", ".join(
                f"{c} {v:.3f} ms" for c, v in sorted(row.items())) + f" (total "
                f"{sum(row.values()):.3f} ms a step)")


def _labels(cfg, prefill: bool) -> list:
    """One forward's segments in launch order as ``_xsplit`` reads them,
    (label, port products): what runs before the first norm, the encoder's
    layers and final norm (encdec prefill), each decoder sublayer (a
    cross-attention decode step makes 2 products, ``wq`` and ``wo``), the
    final norm and head."""
    from repro_torch.configs.base import ATTN, MLP, XATTN

    names = {ATTN: ("self-attention", 4), XATTN: ("cross-attention", 4 if prefill else 2),
             MLP: ("MLP", 3)}
    if not prefill:
        first = [("embedding", 0)]
    elif cfg.family == "encdec":
        first = ([("context cast, ctx_proj (torch.matmul)", 0)]
                 + [("encoder attention", 4), ("encoder MLP", 3)] * cfg.n_enc_layers
                 + [("encoder norm, embedding", 0)])
    else:
        first = [("context cast, ctx_proj (torch.matmul), embedding", 0)]
    dec = [names[k] for _ in range(cfg.n_periods) for layer in cfg.layer_period
           for k in layer]
    return first + dec + [("final norm, head", 0)]


def _xattn_serve(dev, name: str, prompt: int, steps: int = 32, short: int = 223) -> dict:
    """Phase 10's serving part for one arch at its published width and depth
    (bf16, seeded weights): a batch of 4 prompts of ``prompt`` tokens, each
    with its context (``lm.context_len(cfg, prompt)`` tokens of d_ctx,
    ``normal * 0.1`` from a seeded numpy generator), through
    ``lm.prefill(..., ctx_embeds)`` into a cache of ``prompt + steps``
    positions, greedy ``lm.decode_step``s to ``steps`` tokens (each read
    back, as an engine does), then a batch-4 prefill of ``short`` tokens;
    launches exactly ``serve_launches``; host-clock times and peak memory;
    traces of 4 decode steps and of the long prefill split by sublayer
    (``_xsplit``); one full-width cross-attention sublayer held to the CPU
    path (prefill and decode step).  Returns the launches."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_leaves
    from repro_torch.testing.timing import now
    from repro_torch.train.trainer import serve_launches

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(name)
    t0 = now()
    params = init_params(lm.model_defs(cfg), torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    T, Ts = lm.context_len(cfg, prompt), lm.context_len(cfg, short)
    rng = np.random.default_rng(0)
    t1 = now()
    draw = lambda n: torch.from_numpy(rng.standard_normal((4, n, cfg.d_ctx),
                                                          dtype=np.float32)
                                      * np.float32(0.1)).to(dev)
    ctx, short_ctx = draw(T), draw(Ts)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, prompt))).to(dev)
    short_toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, short))).to(dev)
    enc = (f", {cfg.n_enc_layers} encoder layers" if cfg.family == "encdec" else "")
    print(f"[xattn] {cfg.name}: {cfg.n_layers} layers (full depth){enc}, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, d_ctx {cfg.d_ctx}, {str(cfg.dtype)[6:]}; "
          f"{cfg.n_params() / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB of weights "
          f"drawn in {t1 - t0:.1f}s; contexts (4, {T}, {cfg.d_ctx}) and (4, {Ts}, "
          f"{cfg.d_ctx}) f32 drawn in {now() - t1:.1f}s")
    max_seq = prompt + steps
    ops.reset_launches()
    out = []
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = now()
        cache, lg = lm.prefill(params, toks, cfg, max_seq, ctx)
        tok = lg[:, -1].argmax(-1)[:, None]
        out.append(tok[:, 0].tolist())         # a host read: the prefill is done
        t1 = now()
        finite = bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
        for i in range(steps - 1):
            lg, cache = lm.decode_step(params, tok, cache, prompt + i, cfg)
            tok = lg[:, -1].argmax(-1)[:, None]
            out.append(tok[:, 0].tolist())
        t2 = now()
        finite = finite and bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
        _, lg_s = lm.prefill(params, short_toks, cfg, short + 1, short_ctx)
        lg_s[0, -1, 0].item()
        t3 = now()
    launches = dict(ops.LAUNCHES)
    want = serve_launches(cfg, prefills=2, decode_steps=steps - 1)
    peak = torch.cuda.max_memory_allocated()
    print(f"[xattn] {cfg.name} serving, batch 4: prefill of {prompt} tokens with {T} "
          f"context tokens {1e3 * (t1 - t0):.1f} ms ({4 * prompt / (t1 - t0):.1f} prompt "
          f"tok/s), {steps - 1} decode steps {1e3 * (t2 - t1) / (steps - 1):.2f} ms/step "
          f"({4 * (steps - 1) / (t2 - t1):.1f} tok/s), prefill of {short} tokens "
          f"{1e3 * (t3 - t2):.1f} ms (host clock, each ending on a host read; the "
          f"first calls of the run); peak device memory {peak / 1e9:.2f} GB")
    print(f"[xattn] {cfg.name} greedy stream of sample 0: {[o[0] for o in out[:16]]} ...")
    print(f"[xattn] {cfg.name} launches {launches} (expected {want})")
    if not finite or any(t >= cfg.vocab_size for o in out for t in o):
        raise AssertionError(f"{cfg.name}: logits not finite or a token outside the "
                             f"vocabulary")
    if launches != want:
        raise AssertionError(f"{cfg.name} serving launches {launches}, expected {want}")

    with torch.inference_mode():
        # traces: decode steps at batch 4 (each rewriting the last position)
        # and the long prefill, split by sublayer
        def decode_once():
            lgd, _ = lm.decode_step(params, tok, cache, max_seq - 1, cfg)
            lgd[0, -1, 0].item()
        tr = _trace(decode_once, 4)
        _print_trace(tr, 4, f"{cfg.name} decode steps at batch 4 over {T} context "
                     f"tokens")
        _xsplit(tr, _labels(cfg, False), 4, f"{cfg.name} decode at batch 4")

        def prefill_once():
            _, lgp = lm.prefill(params, toks, cfg, max_seq, ctx)
            lgp[0, -1, 0].item()
        tr = _trace(prefill_once, 1)
        _print_trace(tr, 1, f"{cfg.name} prefills of 4 x {prompt} tokens with {T} "
                     f"context tokens")
        _xsplit(tr, _labels(cfg, True), 1, f"{cfg.name} prefill of 4 x {prompt}")

        # the first cross-attention sublayer at full width against the CPU
        li, key = next((f"l{i}", f"s{j}_xattn") for i, layer in
                       enumerate(cfg.layer_period) for j, k in enumerate(layer)
                       if k == "xattn")
        sp = {k: t[0] for k, t in params["period"][li][key].items()}
        c1 = lm.encode_context(params, ctx[:1], cfg)
        x = params["embed"][toks[:1]]
        _xattn_sublayer_check(sp, x, c1, cfg, f"a {prompt}-token prefill against "
                              f"{T} context tokens (sample 0)")
        kv = tuple(t[0, :1] for t in (cache[li][key]["k"], cache[li][key]["v"]))
        _xattn_sublayer_check(sp, params["embed"][tok[:1]], c1, cfg,
                              f"a decode step over the cached {T} context tokens",
                              cache=kv)
    del params, cache, ctx, short_ctx, lg, lg_s, c1, x, kv, sp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _xattn_grad_check(cfg, dev) -> None:
    """One full-width cross-attention sublayer's gradients on the card and
    on the CPU, from the same bf16 weights (seeded), ``XATTN_GRAD_TOKENS``
    embedding rows and a context of ``lm.context_len`` tokens through a
    seeded ``ctx_proj``: the loss sum(y * w) for a seeded f32 w; the
    gradients of x, ctx, wq, wk, wv and wo within ``XATTN_GRAD_RTOL``, and
    the card's the same bits twice."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import layers as Lyr
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.testing import kernel_checks as kc

    one = dataclasses.replace(cfg, n_layers=len(cfg.layer_period))
    defs = lm.model_defs(one)
    sp = init_params(Lyr.xattn_defs(one), torch.Generator(dev).manual_seed(1), dev)
    top = init_params({"embed": defs["embed"], "ctx_proj": defs["ctx_proj"]},
                      torch.Generator(dev).manual_seed(2), dev)
    rng = np.random.default_rng(1)
    T = lm.context_len(cfg, 1024)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, XATTN_GRAD_TOKENS))).to(dev)
    emb = torch.from_numpy(rng.standard_normal((1, T, cfg.d_ctx), dtype=np.float32)
                           * np.float32(0.1)).to(dev)
    with torch.no_grad():
        x = top["embed"][toks]
        ctx = torch.matmul(emb.to(cfg.dtype), top["ctx_proj"])
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    names = ("x", "ctx", "wq", "wk", "wv", "wo")
    got = {}
    for where, d in (("card", dev), ("card again", dev), ("cpu", "cpu")):
        p = tree_map(lambda t: t.detach().to(d).requires_grad_(True), sp)
        xx, cc = (t.detach().to(d).requires_grad_(True) for t in (x, ctx))
        y = Lyr.xattn_layer(p, xx, cc, one)
        loss = (y.float() * w.to(d)).sum()
        got[where] = torch.autograd.grad(loss, [xx, cc] + [p[k] for k in names[2:]])
    same = all(torch.equal(a, b) for a, b in zip(got["card"], got["card again"]))
    res = {n: kc.compare(g.cpu(), want, (XATTN_GRAD_RTOL,
                                         XATTN_GRAD_RTOL * want.abs().max().float()))
           for n, g, want in zip(names, got["card"], got["cpu"])}
    print(f"[xattn-train] cross-attention sublayer gradients vs CPU, "
          f"{XATTN_GRAD_TOKENS} tokens against {T} context tokens: " + "; ".join(
              f"d{n} limit_use {r['limit_use']:.3f} max_abs_err {r['max_abs_err']:.2e}"
              for n, r in res.items())
          + f" (|err| <= {XATTN_GRAD_RTOL:.0e} (|cpu| + max|cpu|)); the card's "
          f"gradients the same bits twice: {same}")
    if not same or not all(r["ok"] for r in res.values()):
        raise AssertionError(f"cross-attention sublayer gradients differ: {same} {res}")


def _xattn_parts(cfg, dev, batch: int = 4, seq: int = 1024) -> None:
    """Where a train step's device time goes in the parts its trace does not
    tell from their neighbours: one full-width cross-attention sublayer and,
    for encdec, the whole encoder with ``ctx_proj``, each at the step's
    shapes with seeded weights, forward alone and forward with backward
    (the encoder under remat), device ms a call from a trace
    (``_device_call``); backward = the difference."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import layers as Lyr
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_leaves, tree_map

    one = dataclasses.replace(cfg, n_layers=len(cfg.layer_period))
    T = lm.context_len(cfg, seq)
    g = torch.Generator(dev).manual_seed(4)
    sp = tree_map(lambda t: t.requires_grad_(True),
                  init_params(Lyr.xattn_defs(one), g, dev))
    x, c, dy = (torch.randn((batch, n, cfg.d_model), generator=g, device=dev)
                .to(cfg.dtype) for n in (seq, T, seq))
    x.requires_grad_(True)
    c.requires_grad_(True)
    leaves = [x, c] + list(sp.values())
    fwd = lambda: Lyr.xattn_layer(sp, x, c, one)
    both = lambda: torch.autograd.grad(Lyr.xattn_layer(sp, x, c, one), leaves, dy)
    f_ms, t_ms = _device_call(fwd, 3), _device_call(both, 3)
    n_x = cfg.n_periods * sum(layer.count("xattn") for layer in cfg.layer_period)
    print(f"[split] {cfg.name} train step parts: one cross-attention sublayer "
          f"({batch} x {seq} rows against {batch} x {T} context rows) forward "
          f"{f_ms:.3f} ms, backward {t_ms - f_ms:.3f} ms (device ms a call), "
          f"{n_x} such sublayers in the model")
    del sp, x, c, dy, leaves
    if cfg.family != "encdec":
        return
    defs = lm.model_defs(one)
    p = tree_map(lambda t: t.requires_grad_(True),
                 init_params({"encoder": defs["encoder"], "ctx_proj": defs["ctx_proj"]},
                             torch.Generator(dev).manual_seed(5), dev))
    emb = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (batch, T, cfg.d_ctx), dtype=np.float32) * np.float32(0.1)).to(dev)
    dc = torch.randn((batch, T, cfg.d_model), generator=g, device=dev).to(cfg.dtype)
    leaves = tree_leaves(p)
    fwd = lambda: lm.encode_context(p, emb, cfg)
    both = lambda: torch.autograd.grad(lm.encode_context(p, emb, cfg), leaves, dc)
    f_ms, t_ms = _device_call(fwd, 2), _device_call(both, 2)
    print(f"[split] {cfg.name} train step parts: the encoder ({cfg.n_enc_layers} "
          f"layers over {batch} x {T} frames, ctx_proj included, remat {cfg.remat}) "
          f"forward {f_ms:.3f} ms, backward with its recompute {t_ms - f_ms:.3f} ms "
          f"(device ms a call)")
    del p, emb, dc, leaves
    torch.cuda.empty_cache()


def _xattn_path(dev) -> dict:
    """Phase 10: the cross-attention families.  The smoke models card
    against CPU (``_xattn_smoke``); llama-3.2-vision-11b serving at its
    published width and all 40 layers (4 prompts of 512 tokens, each with
    its 6,404 image tokens, 32 greedy tokens, then a 223-token batch);
    seamless-m4t-large-v2 serving whole (24 decoder and 24 encoder layers;
    4 prompts of 1,024 tokens with 256 frames); seamless training whole (3
    steps at 4 x 1,024 with 256 frames, remat, phase 7's ``OptConfig``
    defaults); llama-3.2-vision training at its width, ``VLM_TRAIN_PERIODS``
    of its 8 periods (3 steps at 4 x 1,024, each sample with its 6,404
    image tokens); launches exactly ``serve_launches`` / ``step_launches``;
    traces; one full-width cross-attention sublayer's output and gradients
    held to the CPU path.  Returns the launches by part."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config

    _xattn_smoke(dev)
    out = {"xattn_vlm_serve": _xattn_serve(dev, "llama-3.2-vision-11b", 512)}
    out["xattn_s2s_serve"] = _xattn_serve(dev, "seamless-m4t-large-v2", 1024)
    s2s = get_config("seamless-m4t-large-v2")
    out["xattn_s2s_train"] = _train_path(s2s, dev, n_layers=s2s.n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    _xattn_parts(s2s, dev)
    vlm = get_config("llama-3.2-vision-11b")
    n_layers = VLM_TRAIN_PERIODS * len(vlm.layer_period)
    print(f"[xattn-train] {vlm.name}: {n_layers} of {vlm.n_layers} layers "
          f"({VLM_TRAIN_PERIODS} of {vlm.n_periods} periods, "
          f"{dataclasses.replace(vlm, n_layers=n_layers).n_params() / 1e9:.3f} B "
          f"params); {torch.cuda.memory_allocated() / 1e9:.2f} GB live when the "
          f"part began")
    out["xattn_vlm_train"] = _train_path(vlm, dev, n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    _xattn_parts(vlm, dev)
    _xattn_grad_check(vlm, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[xattn] on {smi.splitlines()[0]}")
    return out


def _matmul_bwd_times(kc, kmm, ref, time_ms) -> dict:
    """Phase 6, the matmul's backward of each projection at the training M:
    dA (dX) and dB (dW), one launch each, between CUDA events beside
    torch.matmul's, the plain version and the bound.  Device ms a call of
    each product beside torch.matmul's of it (``_device_call``, a trace of
    20 calls), the pair's their sum; then the forward at the same M (the
    train step's).  Returns rows by projection.
    It uses only what the package has had since the backward kernels came,
    so that ``--only matmul-bwd`` reads an older tree's kernels the same
    way."""
    import torch

    per = {}
    for proj, (K, N) in kc.MATMUL_KN.items():
        M = kc.TRAIN_TOKENS
        dc, b = kc.matmul_bwd_inputs(M, K, N, torch.bfloat16, "a")
        a, dc2 = kc.matmul_bwd_inputs(M, K, N, torch.bfloat16, "b")
        ka = lambda: kmm.grad_a(dc, b)
        kb = lambda: kmm.grad_b(a, dc2)
        la = lambda: torch.matmul(dc, b.T)
        lb = lambda: torch.matmul(a.T, dc2)
        t = {n: time_ms(f, 20) for n, f in (("dA", ka), ("dB", kb), ("lib dA", la),
                                            ("lib dB", lb))}
        t_p = time_ms(lambda: (ref.matmul_grad_a(dc, b), ref.matmul_grad_b(a, dc2)), 5)
        bound, by = _ms_bound(2 * 2 * (M * N + K * N + M * K), 4.0 * M * N * K, "bf16")
        one, _ = _ms_bound(2 * (M * N + K * N + M * K), 2.0 * M * N * K, "bf16")
        dev = {n: _device_call(f, 20) for n, f in (("dA", ka), ("dB", kb),
                                                     ("lib dA", la), ("lib dB", lb))}
        d_k, d_l = dev["dA"] + dev["dB"], dev["lib dA"] + dev["lib dB"]
        fwd_a, fwd_b = kc.matmul_inputs(M, K, N, torch.bfloat16)
        f_k = _device_call(lambda: kmm.matmul(fwd_a, fwd_b), 20)
        f_l = _device_call(lambda: torch.matmul(fwd_a, fwd_b), 20)
        per[proj] = dict(ms=t["dA"] + t["dB"], dA_ms=t["dA"], dB_ms=t["dB"], plain_ms=t_p,
                         library_ms=t["lib dA"] + t["lib dB"], bound_ms=bound,
                         bound_by=by, device_ms=d_k, library_device_ms=d_l,
                         dA_device_ms=dev["dA"], dB_device_ms=dev["dB"],
                         dA_library_device_ms=dev["lib dA"],
                         dB_library_device_ms=dev["lib dB"], product_bound_ms=one,
                         forward_device_ms=f_k, forward_library_device_ms=f_l,
                         shape=f"M={M},K={K},N={N},bf16")
        print(f"[time] matmul_bwd {proj:7s} M={M} K={K:<5d} N={N:<5d} bf16 kernel dA "
              f"{t['dA']:.4f} + dB {t['dB']:.4f} ms  plain {t_p:.4f} ms  torch.matmul "
              f"{t['lib dA']:.4f} + {t['lib dB']:.4f} ms  bound {bound:.4f} ms ({by}); "
              f"device: kernel {d_k:.4f} ms, torch.matmul {d_l:.4f} ms, "
              f"{d_k / d_l:.2f}x torch.matmul, {d_k / bound:.2f}x bound")
        print(f"[time] matmul_bwd {proj:7s} device ms a product (bound {one:.4f} each): "
              f"dX {dev['dA']:.4f} (torch.matmul {dev['lib dA']:.4f}, "
              f"{dev['dA'] / dev['lib dA']:.3f}x), dW {dev['dB']:.4f} (torch.matmul "
              f"{dev['lib dB']:.4f}, {dev['dB'] / dev['lib dB']:.3f}x); dW / dX "
              f"{dev['dB'] / dev['dA']:.3f}; the forward at M={M}: kernel {f_k:.4f}, "
              f"torch.matmul {f_l:.4f}, {f_k / f_l:.3f}x")
        del dc, b, a, dc2, fwd_a, fwd_b
    return per


def _backward_times(kc, kfa, kmm, krms, ref, time_ms) -> dict:
    """Phase 6, the backward kernels at the training shapes: kernel, plain,
    the library call and the bound between CUDA events, and device ms a
    call from a trace (every kernel of one call: two grids for rmsnorm's
    and flash attention's).  Returns rows by name."""
    import torch
    import torch.nn.functional as F

    rows = {}

    def dev_ms(fn):
        return _device_call(fn, 10)

    # rmsnorm: x and dy read, dx written, gamma read and dgamma written
    R, D = kc.TRAIN_TOKENS, kc.D_MODEL
    x, g, dy = kc.rmsnorm_bwd_inputs(R, D, torch.bfloat16)
    xl = x.detach().requires_grad_()
    gl = g.to(torch.bfloat16).requires_grad_()
    yl = F.rms_norm(xl, (D,), gl, kc.EPS)
    fk = lambda: krms.backward(dy, x, g, kc.EPS)
    fl = lambda: torch.autograd.grad(yl, (xl, gl), dy, retain_graph=True)
    t_k, t_p, t_l = (time_ms(fk, 50), time_ms(lambda: ref.rmsnorm_bwd(dy, x, g, kc.EPS), 20),
                     time_ms(fl, 50))
    bound, by = _ms_bound(3 * R * D * 2 + 8 * D, 10.0 * R * D, "f32")
    path = krms.bwd_path(D, torch.bfloat16)
    rows["rmsnorm_bwd"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                               bound_by=by, device_ms=dev_ms(fk),
                               library_device_ms=dev_ms(fl), variant=path,
                               shape=f"R={R},D={D},bf16")
    r = rows["rmsnorm_bwd"]
    print(f"[time] rmsnorm_bwd R={R} D={D} bf16 {path} kernel {t_k:.4f} ms  plain "
          f"{t_p:.4f} ms  F.rms_norm backward (autograd) {t_l:.4f} ms  bound {bound:.5f} ms "
          f"({by}); device: kernel {r['device_ms']:.4f} ms, library "
          f"{r['library_device_ms']:.4f} ms, {r['device_ms'] / r['library_device_ms']:.2f}x "
          f"the library, {r['device_ms'] / bound:.2f}x bound")
    del x, dy, xl, yl
    rows["matmul_bwd"] = _matmul_bwd_times(kc, kmm, ref, time_ms)
    # flash attention at the training shape, causal: q, k, v, do read, dq, dk,
    # dv written; the five products of the backward over the visible pairs
    B, S = 4, 1024
    Hq, Hkv, Dh = kc.HQ, kc.HKV, kc.HEAD_DIM
    q, k, v, do = kc.attention_bwd_inputs(B, S, torch.bfloat16)
    fk = lambda: kfa.backward(q, k, v, do, causal=True)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    fl = lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)
    t_k, t_l = time_ms(fk, 20), time_ms(fl, 20)
    t_p = time_ms(lambda: ref.attention_bwd(q, k, v, do, causal=True), 2)
    pairs = B * Hq * S * (S + 1) / 2
    bound, by = _ms_bound(2 * B * S * Dh * (2 * Hq + 2 * Hkv) * 2, 5 * 2.0 * pairs * Dh,
                          "bf16")
    kind = kfa.bwd_variant(S, S, Dh, torch.bfloat16)
    # the same call through the CUDA-core kernels (the choice forced by
    # lifting `bwd_variant` to them), in the same run
    chooser = kfa.bwd_variant
    kfa.bwd_variant = lambda *a, **kw: "simt"
    simt_dev = dev_ms(fk)
    kfa.bwd_variant = chooser
    rows["flash_attention_bwd"] = dict(
        ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound, bound_by=by,
        device_ms=dev_ms(fk), library_device_ms=dev_ms(fl), variant=kind,
        simt_device_ms=simt_dev,
        shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},D={Dh},causal,bf16")
    r = rows["flash_attention_bwd"]
    print(f"[time] flash_attention_bwd B={B} Hq={Hq} Hkv={Hkv} S={S} D={Dh} causal bf16 "
          f"{kind} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  SDPA backward (autograd) "
          f"{t_l:.4f} ms  bound {bound:.4f} ms ({by}); device: kernel "
          f"{r['device_ms']:.4f} ms (simt kernels {simt_dev:.4f} ms), SDPA backward "
          f"{r['library_device_ms']:.4f} ms, {r['device_ms'] / r['library_device_ms']:.2f}x "
          f"SDPA, {r['device_ms'] / bound:.1f}x bound")
    return rows


def _phi3_flash_times(kc, kfa, ref, time_ms) -> dict:
    """Phase 6, flash attention at phi3-mini's heads (32 over 32 of 96),
    bf16 causal: the forward at a whole prompt of ``PHI3_FLASH_S`` and the
    backward at ``PHI3_FLASH_BWD``.  Kernel, plain and library (SDPA, and
    autograd of it) between CUDA events, the bound, and device ms: each of
    the port's kernels the mean of the kernels so named in a trace
    (``_device_ms``; the backward's dq and dkv grids apart, then summed),
    the library's a call (``_device_call``); and the same calls through the
    simt kernels, forced by lifting ``variant`` / ``bwd_variant`` to them,
    read the same way.  It uses only what the package has had since head
    dim 96 came, so that ``--only phi3`` reads an older tree's kernels the
    same way.  Returns rows "fwd" and "bwd"."""
    import torch
    import torch.nn.functional as F

    Hq, Hkv, D = kc.PHI3_HQ, kc.PHI3_HKV, kc.PHI3_HEAD_DIM
    tags = {"wgmma": "flash_wgmma_kernel", "simt": "flash_kernel"}
    bwd_tags = {"wgmma": ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"),
                "simt": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
    S = kc.PHI3_FLASH_S
    q, k, v = kc.phi3_flash_inputs(S, torch.bfloat16)
    kern = lambda: kfa.flash_attention(q, k, v, causal=True)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    t_k, t_l = time_ms(kern, 50), time_ms(sdpa, 50)
    t_p = time_ms(lambda: ref.attention(q, k, v, causal=True), 20)
    var = kfa.variant(S, S, D, torch.bfloat16)
    d_k, n_k = _device_ms(kern, tags[var], 20)
    d_l = _device_call(sdpa, 20)
    chooser = kfa.variant
    kfa.variant = lambda *a, **kw: "simt"
    d_s, n_s = _device_ms(kern, tags["simt"], 20)
    kfa.variant = chooser
    # q and out once, k and v once; 4 D operations per visible (q, k) pair
    bound, by = _ms_bound(2 * S * D * (2 * Hq + 2 * Hkv), 4.0 * D * Hq * S * (S + 1) / 2,
                          "bf16")
    fwd = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound, bound_by=by,
               device_ms=d_k, library_device_ms=d_l, simt_device_ms=d_s, variant=var,
               shape=f"B=1,Hq={Hq},Hkv={Hkv},S={S},D={D},causal,bf16")
    print(f"[time] flash_attention B=1 Hq={Hq} Hkv={Hkv} D={D} S={S:<4d} causal bf16 "
          f"{var:5s} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  SDPA {t_l:.4f} ms  bound "
          f"{bound:.5f} ms ({by}); device: kernel {d_k:.4f} ms (mean of {n_k} in a "
          f"trace of 20 calls; simt kernel {d_s:.4f}, of {n_s}), SDPA {d_l:.4f} ms a "
          f"call (its kernels' means), {d_k / d_l:.2f}x SDPA (simt {d_s / d_l:.2f}x), "
          f"{d_k / bound:.1f}x bound")
    del q, k, v
    # the backward at the training length: q, k, v, do read, dq, dk, dv
    # written; the five products over the visible pairs
    B, S = kc.PHI3_FLASH_BWD
    q, k, v, do = kc.attention_bwd_inputs(B, S, torch.bfloat16, Hq, Hkv, D)
    fk = lambda: kfa.backward(q, k, v, do, causal=True)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    fl = lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)
    t_k, t_l = time_ms(fk, 20), time_ms(fl, 20)
    t_p = time_ms(lambda: ref.attention_bwd(q, k, v, do, causal=True), 2)
    pairs = B * Hq * S * (S + 1) / 2
    bound, by = _ms_bound(2 * B * S * D * (2 * Hq + 2 * Hkv) * 2, 5 * 2.0 * pairs * D,
                          "bf16")
    var = kfa.bwd_variant(S, S, D, torch.bfloat16)
    (dq, n_dq), (dkv, n_dkv) = (_device_ms(fk, tag, 20) for tag in bwd_tags[var])
    d_l = _device_call(fl, 20)
    chooser = kfa.bwd_variant
    kfa.bwd_variant = lambda *a, **kw: "simt"
    (sq, _), (skv, _) = (_device_ms(fk, tag, 10) for tag in bwd_tags["simt"])
    kfa.bwd_variant = chooser
    bwd = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound, bound_by=by,
               device_ms=dq + dkv, dq_device_ms=dq, dkv_device_ms=dkv,
               library_device_ms=d_l, simt_device_ms=sq + skv, simt_dq_device_ms=sq,
               simt_dkv_device_ms=skv, variant=var,
               shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},D={D},causal,bf16")
    print(f"[time] flash_attention_bwd B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} causal bf16 "
          f"{var} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  SDPA backward (autograd) "
          f"{t_l:.4f} ms  bound {bound:.4f} ms ({by}); device: dq {dq:.4f} + dkv "
          f"{dkv:.4f} = {dq + dkv:.4f} ms (means of {n_dq} and {n_dkv} in traces of 20 "
          f"calls; simt kernels {sq:.4f} + {skv:.4f} = {sq + skv:.4f}), SDPA backward "
          f"{d_l:.4f} ms a call (its kernels' means), {(dq + dkv) / d_l:.2f}x SDPA's (simt "
          f"{(sq + skv) / d_l:.2f}x), {(dq + dkv) / bound:.1f}x bound")
    del q, k, v, do, ql, kl, vl, ol
    return {"fwd": fwd, "bwd": bwd}


#: phase 11's llama3-8b cut: 2 of its 32 layers (1.487 B parameters, 20.82
#: GB a checkpoint at 14 bytes a parameter; three fit the 80.2 GB an H100
#: machine had free under ``build/``)
STATE_LAYERS = 2
#: the bytes a parameter takes in a checkpoint: bf16 weight, f32 master, m, v
STATE_BYTES_A_PARAM = 14


def _leaf_crcs(d: pathlib.Path) -> dict:
    """crc32 of every leaf file of a checkpoint step directory."""
    import zlib

    out = {}
    for f in sorted(d.glob("leaf_*.npy")):
        crc = 0
        with open(f, "rb") as fh:
            while chunk := fh.read(1 << 26):
                crc = zlib.crc32(chunk, crc)
        out[f.name] = crc
    return out


def _state_resume(dev) -> dict:
    """Phase 11a: llama3-8b at its published width cut to ``STATE_LAYERS``
    (bf16, seeded weights, remat, the launcher's optimizer) through
    ``launch.train.run`` with checkpoints: 4 steps at 4 x 1024 saving at
    steps 2 and 4; the step-4 checkpoint's leaf crc32s recorded and the
    directory deleted; the run again with ``resume``, which must restore
    step 2, give steps 2-3's losses bit for bit and rewrite step 4 with the
    same crc32 on every leaf; then step 4 torn, so ``latest_step`` is 2.
    Launches exactly ``step_launches`` a step.  Returns the launches of
    both runs."""
    import dataclasses
    import resource
    import shutil

    import torch

    from repro_torch.checkpoint import latest_step, tear_checkpoint
    from repro_torch.configs import archs, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    from repro_torch.train.trainer import step_launches

    base = get_config("llama3-8b")
    cfg = dataclasses.replace(base, name=f"llama3-8b-{STATE_LAYERS}l",
                              n_layers=STATE_LAYERS)
    ckpt_dir = ROOT / "build" / "state_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free = shutil.disk_usage(ckpt_dir).free
    size = STATE_BYTES_A_PARAM * cfg.n_params()
    print(f"[state] {free} bytes ({free / 1e9:.2f} GB) free under {ckpt_dir}; a "
          f"checkpoint {size / 1e9:.2f} GB")
    if free < 3 * size:
        raise AssertionError(f"the disk holds fewer than three checkpoints "
                             f"({free} bytes free)")
    archs.CONFIGS[cfg.name] = cfg          # registered for the launcher
    kw = dict(smoke=False, steps=4, global_batch=4, seq_len=1024, ckpt_every=2,
              ckpt_dir=str(ckpt_dir), device=dev, log_every=1)
    want = {**{k: 0 for k in ops.LAUNCHES}, **step_launches(cfg)}
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    try:
        print(f"[state] {cfg.name}: {cfg.n_layers} layers of {base.n_layers}, "
              f"{cfg.n_params() / 1e9:.3f} B params, remat {cfg.remat}, "
              f"{str(cfg.dtype)[6:]}; 4 steps at 4 x 1024, a checkpoint every 2")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        first = run(cfg.name, **kw)
        got = dict(ops.LAUNCHES)
        if got != {k: 4 * v for k, v in want.items()}:
            raise AssertionError(f"launches {got}, expected 4 x {want}")
        launches = {k: launches[k] + got[k] for k in launches}
        step4 = ckpt_dir / "step_00000004"
        crcs = _leaf_crcs(step4)
        shutil.rmtree(step4)
        ops.reset_launches()
        second = run(cfg.name, **kw)
        got = dict(ops.LAUNCHES)
        if got != {k: 2 * v for k, v in want.items()}:
            raise AssertionError(f"resumed launches {got}, expected 2 x {want}")
        launches = {k: launches[k] + got[k] for k in launches}
        peak = torch.cuda.max_memory_allocated()
        print(f"[state] first run losses {first['losses']}; resumed at step "
              f"{second['start_step']}: {second['losses']}")
        if second["start_step"] != 2:
            raise AssertionError(f"resumed at {second['start_step']}, not step 2")
        if second["losses"] != first["losses"][2:]:
            raise AssertionError(f"resumed losses {second['losses']} != "
                                 f"{first['losses'][2:]}")
        crcs2 = _leaf_crcs(step4)
        same = crcs2 == crcs
        print(f"[state] rewritten step 4: {len(crcs2)} leaves, crc32 of every leaf "
              f"equal to the first run's: {same}")
        if not same:
            raise AssertionError(f"step-4 leaves differ: "
                                 f"{[k for k in crcs if crcs[k] != crcs2.get(k)]}")
        tear_checkpoint(ckpt_dir, 4)
        latest = latest_step(ckpt_dir)
        print(f"[state] step 4 torn: latest_step {latest}")
        if latest != 2:
            raise AssertionError(f"latest_step {latest} after tearing step 4")
        saves = first["ckpt_timings"] + second["ckpt_timings"]
        for t in saves:
            print(f"[state] save of step {t['step']}: save_async held the step loop "
                  f"{1e3 * t['snapshot_s']:.1f} ms (device-to-host snapshot, "
                  f"{t['nbytes'] / t['snapshot_s'] / 1e9:.2f} GB/s); the writer "
                  f"{t['write_s']:.2f} s, {t['nbytes']} bytes, "
                  f"{t['nbytes'] / t['write_s'] / 1e9:.3f} GB/s to disk")
        nbytes = saves[0]["nbytes"]
        r = second["restore_s"]
        print(f"[state] restore of step 2: {1e3 * r:.1f} ms, {nbytes / r / 1e9:.2f} GB/s "
              f"(the files were written seconds before: the page cache may hold them)")
        # each run's first step is cold: left out
        warm = [(1e3 * t, f) for r in (first, second)
                for t, f in list(zip(r["step_s"], r["save_in_flight"]))[1:]]
        busy = [round(t, 2) for t, f in warm if f]
        idle = [round(t, 2) for t, f in warm if not f]
        print(f"[state] step ms (host clock, ending on the loss's host read; each "
              f"run's first step left out): with a save in flight {busy}, without "
              f"{idle}")
        print(f"[state] peak device memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); "
              f"peak host RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} "
              f"GiB (the process's)")
    finally:
        del archs.CONFIGS[cfg.name]
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches


def _state_path(dev) -> dict:
    """Phase 11: state and resilience on the card.  (a) ``_state_resume``;
    (b) ``testing.check_chaos.main`` (the smoke model from the JAX
    initialiser's weights, 12 steps, a kill, a straggler and a torn
    checkpoint) on the card and on the CPU:
    fingerprints, restarts and timeline equal, losses within
    ``train_checks.SCALAR_RTOL``; (c) ``testing.check_chaos_procs.main``
    with the primary worker on the card: three real SIGKILLs, one of the
    primary mid-save, the failover primary taking the card.  Returns
    (a)'s launches."""
    import torch

    from repro_torch.testing import check_chaos, check_chaos_procs
    from repro_torch.testing import train_checks as tc
    from repro_torch.testing.timing import now

    launches = _state_resume(dev)
    params = tc.smoke_params()             # the JAX initialiser's, on the CPU
    t0 = now()
    cpu = check_chaos.main(device="cpu", params=params)
    t1 = now()
    gpu = check_chaos.main(device=dev, params=params)
    t2 = now()
    for k in ("ref", "chaos"):
        g, c = gpu[k], cpu[k]
        rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], c["losses"]))
        same = (g["fingerprints"] == c["fingerprints"] and g["restarts"] == c["restarts"]
                and g["timeline"] == c["timeline"])
        print(f"[state] check_chaos {k}: card against CPU, fingerprints, restarts and "
              f"timeline equal: {same}; losses rel {rel:.3e} (limit {tc.SCALAR_RTOL:g}); "
              f"card {g['losses']}")
        if not same or rel > tc.SCALAR_RTOL:
            raise AssertionError(f"check_chaos {k}: card and CPU disagree")
    print(f"[state] check_chaos: CPU {t1 - t0:.1f} s, card {t2 - t1:.1f} s")
    torch.cuda.empty_cache()
    t0 = now()
    procs = check_chaos_procs.main(device=str(dev))
    det = [[round(r["detect_s"], 3) for r in procs[k]["restarts"]]
           for k in ("chaos", "again")]
    print(f"[state] check_chaos_procs on the card in {now() - t0:.1f} s: detection "
          f"latencies (s, heartbeat timeout {check_chaos_procs.TIMEOUT_S}) {det}; "
          f"losses {procs['chaos']['losses']}")
    return launches


# -- phase 12: distributed compute, four ranks sharing the card ---------------

#: the ranks of phase 12 (they share the one card: gloo, through host buffers)
DIST_RANKS = 4
#: (a)'s losses, 4 ranks against one process: rtol.  On the H100 they
#: read 5e-7 at step 1 and 1.4e-5 at step 3, the loss moving 0.83 over
#: the 3 steps: 1e-3 leaves room on both sides and
#: still fails an update or a leaf's sync that is off by a few percent
DIST_LOSS_RTOL = 1e-3
#: (a)'s gradient norms (before clipping): rtol.  On the H100 they read
#: 2.03e-3, nearly all of it the embedding's: the one process's bf16
#: scatter-add (``EMBED_ACC_ULP``) rounds a frequent row's hundreds of
#: adds one at a time and reads ~1.5 % low in that leaf's norm, a rank
#: adds half as many; 1e-2 leaves room for that, and the gradient samples
#: (``DIST_GRAD_RTOL``) hold each leaf
DIST_GNORM_RTOL = 1e-2
#: (a)'s step-1 gradient, sampled from 9 leaves on every rank, against one
#: process: ``|d| <= DIST_GRAD_RTOL (|want| + max|want|)`` as the MoE
#: sublayer's (``MOE_GRAD_RTOL``): one bf16 ulp of the element (the bf16
#: partials summed over the data ranks, the tensor-parallel products'
#: partials over `model`) and one of the leaf's largest element, for what
#: one-ulp differences in the bf16 activations carry into every element
DIST_GRAD_RTOL = 8e-3
#: ... but the embedding's gradient is a bf16 scatter-add: a row gets its
#: token's k cotangents one at a time, each sum rounded to bf16 (the one
#: process's and each rank's ``index_put_`` with accumulate), and a Zipf
#: corpus gives its first rows hundreds each.  So that leaf is held to the
#: f32 sum of the one process's cotangents, with the rounding of those
#: sums on top: at most half a bf16 ulp (2^-8 of) the row's sum of
#: |cotangents| for each of the k adds and for the sum over the data ranks
EMBED_ACC_ULP = 2**-8
#: (c)'s logits, 4 ranks against one process: |d| <= this share of the
#: largest |logit| of the step (the bf16 roundings of (a), through 2
#: layers and the head)
DIST_LOGIT_SHARE = 5e-2


def _dist_readings(tag: str, stats: list, smi: str, unit: str = "rank") -> None:
    """The readings of one part (``testing.subproc.readings``), one a rank
    or, with ``unit="step"``, one a step of one rank."""
    for i, st in enumerate(stats):
        peak = st.get("peak_bytes")
        print(f"[dist] {tag} {unit} {i}: {st['ms']:.1f} ms, {st['collective_ms']:.1f} ms "
              f"inside collectives (host clock), {st['bytes'] / 1e6:.1f} MB sent, peak "
              f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}; {smi}")


def _dist_train(dev, smi) -> dict:
    """Phase 12a: llama3-8b at its published width, 2 of 32 layers, 3 steps
    at 4 x 1024 under remat, in one process on the card and then on a (2, 2)
    mesh of 4 ranks: losses and gradient norms, and samples of 9 leaves'
    step-1 gradients on every rank, against the one process; each rank's
    launches a step exactly ``step_launches``.  Returns rank 0's launches
    over the 3 steps."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import block, default_rules, param_placements
    from repro_torch.testing import check_dist_train as cdt
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.testing.subproc import run_ranks
    from repro_torch.testing.timing import now
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import init_train_state, loss_and_grads, step_launches

    import gc

    arch = "llama3-8b"
    cfg, opt_cfg = cdt.config(arch, "full"), cdt.opt_config("full")
    bs = cdt.batches(arch, "full")
    defs = lm.model_defs(cfg)
    mesh = Mesh.abstract((2, 2), ("data", "model"))
    rules = default_rules(mesh, batch=bs[0].shape[0])
    specs = cdt.flat(param_placements(defs, rules))
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, opt_cfg, torch.Generator(dev).manual_seed(0), dev)
    g0, embed = _dist_embed_grad(lm, loss_and_grads, state.params, bs[0].to(dev), cfg)
    norms0 = cdt.leaf_norms(g0, defs)
    g0 = cdt.flat(g0)

    def samples(t, k):
        return [cdt.sample(block(t, specs[k], mesh, r)).cpu() for r in range(DIST_RANKS)]
    want = {k: samples(g0[k], k) for k in cdt.FULL_LEAVES}
    # the embedding: the f32 sum, its rounding allowance, the one process's bf16
    want["embed"] = samples(embed["f32"], "embed")
    allow = samples(embed["allow"], "embed")
    one_embed = kc.compare(g0["embed"].float(), embed["f32"],
                           (DIST_GRAD_RTOL, DIST_GRAD_RTOL * embed["f32"].abs().max()
                            + embed["allow"]))
    one_embed["norms"] = (float(embed["f32"].norm()), float(g0["embed"].float().norm()))
    del g0, embed
    step = make_train_step(cfg, opt_cfg)
    one, one_ms = [], []
    for b in bs:
        torch.cuda.synchronize()
        t0 = now()
        state, m = step(state, {"tokens": b.to(dev)})
        one.append({k: float(v) for k, v in m.items()})
        one_ms.append(1e3 * (now() - t0))
    print(f"[dist] (a) {arch}: {cfg.n_layers} of 32 layers, d_model {cfg.d_model}, "
          f"{cfg.n_params() / 1e9:.3f} B parameters, 3 steps at {bs[0].shape[0]} x "
          f"{bs[0].shape[1]} tokens, remat; one process: losses "
          f"{[m['loss'] for m in one]}, grad norms {[m['grad_norm'] for m in one]}, "
          f"step ms {[round(t, 1) for t in one_ms]}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    n_whole = sum(t.numel() for t in cdt.flat(state.params).values())
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[dist] (a) the one process holds {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB on the card before the spawn")
    t0 = now()
    d = run_ranks("repro_torch.testing.check_dist_train", DIST_RANKS, "2", "2",
                  "--size", "full", "--archs", arch, device="cuda", timeout=900)
    print(f"[dist] (a) 4 ranks on a (2, 2) mesh (data, model) in {now() - t0:.1f} s, "
          f"spawn included")
    runs = [torch.load(f"{d}/rank{r}.pt", weights_only=False)["archs"][arch]
            for r in range(DIST_RANKS)]
    ranks = [r["full"] for r in runs]
    print(f"[dist] (a) parameters a rank: {[r['n_params'] for r in runs]} (of "
          f"{n_whole} in one process)")
    want_l = {**{k: 0 for k in ops.LAUNCHES}, **step_launches(cfg, 1, rules)}
    worst = {"loss": 0.0, "grad_norm": 0.0, "grad": 0.0}
    grads = {}
    for r, rk in enumerate(ranks):
        for g, w in zip(rk["metrics"], one):
            for k in ("loss", "grad_norm"):
                worst[k] = max(worst[k], abs(g[k] - w[k]) / abs(w[k]))
        for k in cdt.FULL_LEAVES:
            w = want[k][r]
            atol = DIST_GRAD_RTOL * w.abs().max().float() + (allow[r] if k == "embed" else 0)
            res = kc.compare(rk["grads0"][k].float() if k == "embed" else rk["grads0"][k], w,
                             (DIST_GRAD_RTOL, atol))
            use = res["limit_use"] if res["ok"] or res["limit_use"] > 1.0 else float("inf")
            grads[k] = max(grads.get(k, 0.0), use)
        _dist_readings(f"(a) train step, rank {r},", rk["steps"], smi, unit="step")
        bad = [st["launches"] for st in rk["steps"] if st["launches"] != want_l]
        if bad:
            raise AssertionError(f"(a) rank {r} launches {bad[0]}, expected {want_l}")
        print(f"[dist] (a) rank {r}: losses {[m['loss'] for m in rk['metrics']]}, grad "
              f"norms {[m['grad_norm'] for m in rk['metrics']]}, launches a step "
              f"{rk['steps'][0]['launches']} (step_launches), peak "
              f"{(rk['peak_bytes'] or 0) / 2**30:.2f} GiB")
    worst["grad"] = max(grads.values())
    rel = {k: (ranks[0]["norms0"][k] - v) / v for k, v in norms0.items() if v > 0}
    print(f"[dist] (a) 4 ranks against one process: losses rel {worst['loss']:.3e} "
          f"(limit {DIST_LOSS_RTOL}), grad norms rel {worst['grad_norm']:.3e} (limit "
          f"{DIST_GNORM_RTOL}); step-1 gradient samples of every rank's block, limit use "
          f"(|d| <= {DIST_GRAD_RTOL} (|one| + max|one|); the embedding against the f32 "
          f"sum of the one process's cotangents, plus (k + 1) {EMBED_ACC_ULP} sum|cot| a "
          f"row): " + ", ".join(f"{k} {v:.3f}" for k, v in grads.items())
          + f"; the one process's bf16 embedding gradient against the same: limit use "
          f"{one_embed['limit_use']:.3f}, max |d| {one_embed['max_abs_err']:.3e}; the "
          f"embedding gradient's norm: f32 sum {one_embed['norms'][0]:.4f}, one process "
          f"{one_embed['norms'][1]:.4f}, 4 ranks {ranks[0]['norms0']['embed']:.4f}")
    print("[dist] (a) step-1 gradient norm a leaf, 4 ranks against one process (rel): "
          + ", ".join(f"{k} {norms0[k]:.4g} {v:+.2e}"
                      for k, v in sorted(rel.items(), key=lambda kv: -abs(kv[1]))))
    if (worst["loss"] > DIST_LOSS_RTOL or worst["grad_norm"] > DIST_GNORM_RTOL
            or worst["grad"] > 1.0):
        raise AssertionError(f"(a) 4 ranks and one process disagree: {worst}")
    return {k: sum(st["launches"][k] for st in ranks[0]["steps"]) for k in ops.LAUNCHES}


def _dist_embed_grad(lm, loss_and_grads, params, tokens, cfg) -> tuple:
    """(gradient tree, embedding) of one process's loss at ``tokens``,
    the embedding's ``{"f32": the f32 sum of the cotangents of each row's
    lookups, "allow": (k + 1) EMBED_ACC_ULP sum |cotangent| a row}``, k
    the row's count in ``tokens``: the cotangent of the lookup's output
    caught by a hook on ``lm.embed_tokens`` for this call."""
    import torch

    caught = {}
    lookup = lm.embed_tokens

    def hooked(*a, **kw):
        x = lookup(*a, **kw)
        x.register_hook(lambda g: caught.setdefault("cot", g.detach()))
        return x
    lm.embed_tokens = hooked
    try:
        _, g = loss_and_grads(params, tokens, cfg)
    finally:
        lm.embed_tokens = lookup
    rows = tokens.reshape(-1)
    cot = caught.pop("cot").float().reshape(rows.numel(), -1)
    shape = g["embed"].shape
    f32 = torch.zeros(shape, device=cot.device).index_add_(0, rows, cot)
    allow = torch.zeros(shape, device=cot.device).index_add_(0, rows, cot.abs())
    k = torch.bincount(rows, minlength=shape[0]).float()
    allow.mul_(((k + 1) * EMBED_ACC_ULP)[:, None])
    return g, {"f32": f32, "allow": allow}


def _dist_moe(dev, smi) -> None:
    """Phase 12b: one MoE sublayer at its published width on a (1, 4) mesh:
    qwen3-moe in ep and ep_a2a (128 experts of 1,536, top-8, 32 a rank) and
    mixtral in tp (8 experts, d_ff 14,336 cut by 4), 4 x 256 tokens, each
    within ``kernel_checks.moe_tol`` of the one-process sublayer (for
    ep_a2a, over each rank's sequence slice: its capacity is the slice's,
    as the reference's is the shard's); the hierarchical all-to-all on a
    2 x 2 topology bit-equal to the flat one."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.testing import check_dist_moe as cdm
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.testing.subproc import run_ranks
    from repro_torch.testing.timing import now

    want, tols = {}, {}
    for name, (_, _, modes) in cdm.FULL.items():
        cfg, _, params, x, _ = cdm.inputs(name, "full", dev)
        for mode in modes:
            # ep_a2a dispatches each rank's sequence slice with its own
            # capacity (the reference's per-shard C): its one-process
            # counterpart is the sublayer over each slice
            parts = (x.chunk(DIST_RANKS, dim=1) if mode == "ep_a2a" else (x,))
            with torch.no_grad():
                ys = [L.moe_layer(params, xs, cfg) for xs in parts]
                tl = [kc.moe_tol(params, xs, cfg)[1].reshape(*xs.shape[:2], 1)
                      for xs in parts]
            want[(name, mode)] = torch.cat(ys, dim=1).reshape(-1, cfg.d_model).cpu()
            tols[(name, mode)] = (kc.MATMUL_TOL[torch.bfloat16][0],
                                  torch.cat(tl, dim=1).reshape(-1, 1).cpu())
        del params, x
        torch.cuda.empty_cache()
    t0 = now()
    d = run_ranks("repro_torch.testing.check_dist_moe", DIST_RANKS, "1", "4",
                  "--size", "full", "--cases", *cdm.FULL, device="cuda", timeout=900)
    print(f"[dist] (b) 4 ranks on a (1, 4) mesh in {now() - t0:.1f} s, spawn included")
    got = cdm.assemble(d, DIST_RANKS, "full")
    for key, g in got.items():
        if key == "hier":
            continue
        name, mode = key
        cfg, _ = cdm.case_config(name, "full")
        res = kc.compare(g["y"].reshape(-1, cfg.d_model), want[key], tols[key])
        B, S = cdm.TOKENS["full"]
        local = (cfg.n_experts if mode == "tp" else cfg.n_experts // DIST_RANKS)
        print(f"[dist] (b) {cfg.name} {mode}: {cfg.n_experts} experts of "
              f"{cfg.d_ff_expert} ({local} a rank{', d_ff cut by 4' if mode == 'tp' else ''}), "
              f"top-{cfg.experts_per_token}, {B} x {S} tokens, "
              f"{DIST_RANKS} ranks against one process"
              f"{' (each sequence slice: its capacity)' if mode == 'ep_a2a' else ''}: "
              f"{_reading(res)} (moe_tol)")
        _dist_readings(f"(b) {name} {mode}", g["stats"], smi)
        if not res["ok"]:
            raise AssertionError(f"(b) {name} {mode} differs from one process: {res}")
    h = got["hier"]
    print(f"[dist] (b) hierarchical all-to-all on a {'x'.join(map(str, h['levels']))} "
          f"topology: bit-equal to the one-stage and the flat-axis exchange on every "
          f"rank: {h['all_ranks_same']}")
    if not h["all_ranks_same"]:
        raise AssertionError("(b) the hierarchical all-to-all differs from the flat one")


def _dist_decode(dev, smi) -> None:
    """Phase 12c: llama3-8b at its published width, 2 layers, decoding 16
    steps over a 4,096-slot cache cut over `model` (1,024 slots a rank, a
    (1, 4) mesh) after a 512-token prefill at batch 4: each step's logits
    against one process's ``decode_step`` (``DIST_LOGIT_SHARE``), and
    whether the greedy tokens agree."""
    import torch

    from repro_torch.testing import check_dist_decode as cdd
    from repro_torch.testing.subproc import run_ranks
    from repro_torch.testing.timing import now

    arch = "llama3-8b"
    one = cdd.expected(arch, "full", dev)
    want = one["logits"].float().cpu()
    del one
    torch.cuda.empty_cache()
    t0 = now()
    d = run_ranks("repro_torch.testing.check_dist_decode", DIST_RANKS, "1", "4",
                  "--size", "full", device="cuda", timeout=900)
    print(f"[dist] (c) 4 ranks on a (1, 4) mesh in {now() - t0:.1f} s, spawn included")
    got = cdd.assemble(d, DIST_RANKS, "full")[(arch, "cache_seq")]
    g = got["logits"].float()
    share = float(((g - want).abs().amax(dim=(1, 2, 3))
                   / want.abs().amax(dim=(1, 2, 3))).max())
    agree = (g.argmax(-1) == want.argmax(-1)).float().mean().item()
    _, B, P, W, steps = cdd.SIZES["full"]
    print(f"[dist] (c) {arch} 2 layers, prefill {B} x {P} then {steps} steps over a "
          f"{W}-slot cache ({W // 4} a rank): logits against one process at most "
          f"{share:.3e} of the step's largest |logit| (limit {DIST_LOGIT_SHARE}); "
          f"greedy tokens agree on {100 * agree:.1f} % of the {(steps + 1) * B}")
    _dist_readings("(c) prefill + decode", got["stats"], smi)
    print(f"[dist] (c) rank 0's launches {got['launches'][0][0]} (serve_launches "
          f"with the mesh, a prefill and {steps} steps: {got['launches'][0][1]})")
    if share > DIST_LOGIT_SHARE or not torch.isfinite(g).all():
        raise AssertionError(f"(c) decode logits differ from one process: {share}")
    if any(c != w for c, w in got["launches"]):
        raise AssertionError(f"(c) launches {got['launches']}")


def _dist_ring(dev, smi) -> None:
    """Phase 12d: ring attention at (1, 16384, 32/8, 128) bf16 over 4 ranks,
    the flat ring (seq and db) and the 2 x 2 hierarchical one, causal and
    with a window of 4,096, against the flash kernel in one process
    (``ATTN_TOL[bf16]``); db bit-equal to seq."""
    import torch

    from repro_torch.testing import check_dist_ring as cdr
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.testing.subproc import run_ranks
    from repro_torch.testing.timing import now

    want = {c: cdr.expected("full", dev, *c).cpu() for c in cdr.CASES["full"]}
    torch.cuda.empty_cache()
    t0 = now()
    d = run_ranks("repro_torch.testing.check_dist_ring", DIST_RANKS, str(DIST_RANKS),
                  "--size", "full", device="cuda", timeout=900)
    print(f"[dist] (d) 4 ranks in {now() - t0:.1f} s, spawn included")
    got = cdr.assemble(d, DIST_RANKS)
    tol = kc.ATTN_TOL[torch.bfloat16]
    B, S, H, Hkv, D, _ = cdr.SHAPES["full"]
    for (causal, window), r in got.items():
        res = {t: kc.compare(r[t], want[(causal, window)], tol) for t in ("seq", "hier")}
        diff = float((r["hier"].float() - r["seq"].float()).abs().max())
        print(f"[dist] (d) ring attention ({B}, {S}, {H}/{Hkv}, {D}) bf16 causal window="
              f"{window}: flat {_reading(res['seq'])}; 2 x 2 hierarchical "
              f"{_reading(res['hier'])} (ATTN_TOL[bf16], against the flash kernel in "
              f"one process); |hier - flat| {diff:.3e}; db == seq bitwise "
              f"{r['db_same']}")
        for t in ("seq", "db", "hier"):
            _dist_readings(f"(d) {t} window={window}", r["stats"][t], smi)
        if not all(x["ok"] for x in res.values()) or not r["db_same"]:
            raise AssertionError(f"(d) ring attention window={window}: {res}")


def _dist_path(dev, smi) -> dict:
    """Phase 12: distributed compute with four ranks sharing the card (the
    backend and transport ``parallel.comm.layout`` gives: gloo, each CUDA
    tensor a collective sends through a host buffer).  Every number is
    a rank's on a shared card through the host, not NCCL over NVLink.
    Returns (a)'s rank-0 launches."""
    from repro_torch.parallel.comm import layout

    import torch

    backend, transport = layout("cuda", DIST_RANKS, torch.cuda.device_count())
    print(f"[dist] {DIST_RANKS} ranks, {torch.cuda.device_count()} card: backend "
          f"{backend}, transport {transport}; {smi}")
    launches = _dist_train(dev, smi)
    _dist_moe(dev, smi)
    _dist_decode(dev, smi)
    _dist_ring(dev, smi)
    return launches


# -- phase 13: state and serving on a mesh, eight ranks sharing the card ------

#: phase 13's ranks: a (2, 2, 2) (pod, data, model) mesh for serving and
#: the chaos harness's (4, 2) one
MESH_RANKS = 8


def _mesh_readings(tag: str, ranks: list, engine: str, smi: str) -> None:
    """Each rank's readings of one engine's run: host ms a decode step (the
    engine's own span), ms inside collectives and bytes sent over the whole
    run, peak device memory, and the engine's TTFT."""
    for r, res in enumerate(ranks):
        e = res[engine]
        t, st = e["timing"], e["stats"]
        peak = st.get("peak_bytes")
        print(f"[mesh] {tag} {engine} rank {r}: decode "
              f"{1e3 * t['decode_s'] / max(t['decode_steps'], 1):.2f} ms a step "
              f"({t['decode_steps']} steps), {st['collective_ms']:.1f} ms inside "
              f"collectives of {st['ms']:.1f} ms, {st['bytes'] / 1e6:.1f} MB sent, "
              f"peak {'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}, TTFT ms "
              f"{[round(x, 1) for x in e['ttft_ms']]}; {smi}")


def _mesh_serve(dev, smi) -> dict:
    """Phase 13a: llama3-8b at its published width, 2 of 32 layers (eight
    ranks share the card through host buffers), on a (2, 2, 2) mesh: the
    dense engine blind and topology-aware (``check_serve_topology --size
    full``), the paged engine whole and chunked and the router
    (``check_serve_paged --size full``), batch 4, prompts of 64-512
    tokens, 16 new tokens each; every assertion of the CPU checks (the
    streams between engines measured), each rank's launches exactly
    ``serve_launches``, and every engine's logits against the same engine
    in one process on the card (``DIST_LOGIT_SHARE``, greedy agreement
    printed).  Returns rank 0's launches over the four engines."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.testing import check_serve_paged as csp
    from repro_torch.testing import check_serve_topology as cst
    from repro_torch.testing.subproc import run_ranks
    from repro_torch.testing.timing import now

    cfg = cst.config("full")
    model = lm.Model(cfg, cst.weights("full", dev))
    t0 = now()
    one = {"topology": cst.run(model, "full", device=dev),
           "paged": csp.run(model, "full", device=dev)}
    print(f"[mesh] (a) {cfg.name} {cfg.n_layers} of 32 layers, d_model {cfg.d_model}: "
          f"the engines in one process on the card in {now() - t0:.1f} s")
    for part in one.values():
        for tag, e in part.items():
            if tag != "router" and e["launches"][0] != e["launches"][1]:
                raise AssertionError(f"(a) one process {tag}: {e['launches']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: 0 for k in ops.LAUNCHES}
    for part, mod, chk, tags in (("topology", "check_serve_topology", cst.check,
                                  ("blind", "aware")),
                                 ("paged", "check_serve_paged", csp.check,
                                  ("dense", "paged", "chunked"))):
        t0 = now()
        d = run_ranks(f"repro_torch.testing.{mod}", MESH_RANKS, "--size", "full",
                      device="cuda", timeout=900)
        ranks = cst.assemble(d)
        print(f"[mesh] (a) {mod}: {MESH_RANKS} ranks on a (2, 2, 2) (pod, data, model) "
              f"mesh in {now() - t0:.1f} s, spawn included")
        out = chk(ranks, strict=False)
        if part == "topology":
            a = out["aware"]
            print(f"[mesh] (a) placement: the topology engine's cache cut over "
                  f"{sorted(a['axes'][1])} (never `pod`), a rank's slots "
                  f"{[r['aware']['slot_rows'] for r in ranks]}; repeat of r2 in slot "
                  f"{a['streams'][3][0]} (pod 1), blind engine slot "
                  f"{out['blind']['streams'][3][0]}; blind vs aware: {out['blind_vs_aware']}")
        else:
            p = out["paged"]
            print(f"[mesh] (a) paged: shared_hits {p['shared_hits']}, cow_copies "
                  f"{p['cow_copies']}, peak blocks {p['peak_blocks']}, chunks "
                  f"{out['chunked']['timing']['chunks']}, zero block zero on every "
                  f"rank, pool cut over {sorted(p['pool_axes'])}, router "
                  f"{out['router']}; against dense: {out['vs_dense']}")
        for tag in tags:
            g, w = out[tag], one[part][tag]
            ag = cst.agreement(g["streams"], w["streams"], g["logits"], w["logits"])
            print(f"[mesh] (a) {tag}: 8 ranks against one process on the card, greedy "
                  f"picks agree {100 * ag['agree']:.1f} %, logits at most "
                  f"{ag['share']:.3e} of the pick's largest |logit| (limit "
                  f"{DIST_LOGIT_SHARE}); launches a rank {g['launches'][0]} "
                  f"(serve_launches)")
            _mesh_readings("(a)", ranks, tag, smi)
            if ag["share"] > DIST_LOGIT_SHARE:
                raise AssertionError(f"(a) {tag}: logits differ from one process: {ag}")
            for k in launches:
                launches[k] += g["launches"][0].get(k, 0)
        del ranks, out
    return launches


def _mesh_families(dev, smi) -> None:
    """Phase 13 b, c: mamba2-370m's Mamba2 sublayer (32 heads) and
    llama-3.2-vision-11b's cross-attention sublayer (32/8 heads, 6,404
    context tokens; the prefill through the flash kernel) at their
    published widths, cut over `model` on a (1, 4) mesh
    (``check_dist_families --size full``): a prefill and a decode step,
    outputs and caches against one process on the card within
    ``kernel_checks.mamba_tol`` and ``xattn_tol``."""
    import torch

    from repro_torch.params import tree_map
    from repro_torch.testing import check_dist_families as cdf
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.testing.subproc import run_ranks
    from repro_torch.testing.timing import now

    want, tols = {}, {}
    for arch in cdf.FULL_ARCHS:
        cfg = cdf.config(arch, "full")
        p = cdf.slot_params(arch, dev, "full")
        ins = cdf.inputs(arch, "full")
        want[arch] = cdf.sublayer(arch, p, ins, None, dev, "full")
        pc = tree_map(lambda t: t.cpu(), p)
        x, x1, ctx = (torch.from_numpy(ins[k]).to(cfg.dtype) for k in ("x", "x1", "ctx"))
        w = want[arch]
        if cdf.is_mamba(arch):
            t0, t1 = kc.mamba_tol(pc, x, cfg), kc.mamba_tol(
                pc, x1, cfg, w["cache"]["conv"], w["cache"]["state"])
            tols[arch] = {"out": t0["out"], "conv": t0["conv"], "state": t0["state"],
                          "out1": t1["out"], "conv1": t1["conv"], "state1": t1["state"]}
        else:
            mm = kc.MATMUL_TOL[torch.bfloat16]
            tols[arch] = {"out": kc.xattn_tol(pc, x, ctx, cfg), "k": mm, "v": mm,
                          "out1": kc.xattn_tol(pc, x1, ctx, cfg,
                                               (w["cache"]["k"], w["cache"]["v"]))}
        del p
    torch.cuda.empty_cache()
    t0 = now()
    got = cdf.main(["1", "4", "--size", "full", "--device", "cuda"])
    print(f"[mesh] (b, c) 4 ranks on a (1, 4) mesh in {now() - t0:.1f} s, spawn included")
    for part, arch in (("(b)", "mamba2-370m"), ("(c)", "llama-3.2-vision-11b")):
        g, w, t = got[arch], want[arch], tols[arch]
        d = cdf.config(arch, "full").d_model
        pairs = {"out": (g["out"].reshape(-1, d), w["out"].reshape(-1, d)),
                 "out1": (g["out1"].reshape(-1, d), w["out1"].reshape(-1, d))}
        for k in g["cache"]:
            pairs[k] = (g["cache"][k], w["cache"][k])
            if k in ("conv", "state"):
                pairs[k + "1"] = (g["cache1"][k], w["cache1"][k])
        res = {k: kc.compare(a, b, t[k]) for k, (a, b) in pairs.items()}
        print(f"[mesh] {part} {arch} sublayer, 4 ranks against one process on the card: "
              + "; ".join(f"{k} {_reading(r)}" for k, r in res.items())
              + f"; same output on every rank {g['same_out_on_every_rank']}")
        _dist_readings(f"{part} {arch}", g["stats"], smi)
        if not all(r["ok"] for r in res.values()) or not g["same_out_on_every_rank"]:
            raise AssertionError(f"{part} {arch} on the mesh differs: {res}")


def _mesh_state(dev, smi) -> None:
    """Phase 13 d, e: the chaos harness on 8 ranks ((4, 2) -> (2, 2),
    ``check_chaos --mesh``) on the card and on the CPU, fingerprints,
    restarts and timeline equal, losses within ``train_checks.SCALAR_RTOL``;
    a (2, 2) save restored onto (1, 2) and in one process, every leaf's
    crc32 equal (``check_ckpt_mesh``)."""
    from repro_torch.testing import check_chaos, check_ckpt_mesh
    from repro_torch.testing import train_checks as tc
    from repro_torch.testing.timing import now

    t0 = now()
    gpu = check_chaos.main_mesh(["--mesh", "--device", "cuda"])
    t1 = now()
    cpu = check_chaos.main_mesh(["--mesh", "--device", "cpu"])
    t2 = now()
    for k in ("ref", "chaos"):
        g, c = gpu[k], cpu[k]
        rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], c["losses"]))
        same = (g["fingerprints"] == c["fingerprints"] and g["restarts"] == c["restarts"]
                and g["timeline"] == c["timeline"])
        print(f"[mesh] (d) check_chaos --mesh {k}: card against the CPU's ranks, "
              f"fingerprints, restarts and timeline equal: {same}; losses rel {rel:.3e} "
              f"(limit {tc.SCALAR_RTOL:g}); final mesh {g['final_mesh_shape']}; card "
              f"{g['losses']}")
        if not same or rel > tc.SCALAR_RTOL:
            raise AssertionError(f"(d) check_chaos --mesh {k}: card and CPU disagree")
    print(f"[mesh] (d) 8 ranks: card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s, spawns "
          f"included; {smi}")
    t0 = now()
    out = check_ckpt_mesh.main(["--device", "cuda"])
    print(f"[mesh] (e) a (2, 2) save of {out['n_leaves']} leaves restored onto (1, 2) "
          f"and in one process: every leaf's crc32 equal ({now() - t0:.1f} s, 4 ranks)")


def _mesh_path(dev, smi) -> dict:
    """Phase 13: state and serving on a process mesh, the ranks sharing the
    card through host buffers (gloo, ``parallel.comm.layout``), as phase
    12's.  Returns (a)'s rank-0 launches."""
    import torch

    from repro_torch.parallel.comm import layout

    backend, transport = layout("cuda", MESH_RANKS, torch.cuda.device_count())
    print(f"[mesh] {MESH_RANKS} ranks, {torch.cuda.device_count()} card: backend "
          f"{backend}, transport {transport}; {smi}")
    launches = _mesh_serve(dev, smi)
    _mesh_families(dev, smi)
    _mesh_state(dev, smi)
    return launches


# -- phase 14: the paper's machine, one rank a lane, f64 at VLEN 64 Kibit ------

#: phase 14's register length (the paper's flagship VLEN) and rank counts
MACHINE_VLEN_BITS = 65536
MACHINE_RANKS = (8, 16)


def _machine_units(tag: str, stats: list, smi: str) -> None:
    """One part's readings over its ranks: host ms an instruction by unit
    (the slowest rank's), ms inside collectives, bytes sent and peak device
    memory (the largest rank's)."""
    units = {}
    for st in stats:
        for u, (calls, ms) in st["units"].items():
            units[u] = (calls, max(ms, units.get(u, (0, 0.0))[1]))
    peak = [st["peak_bytes"] for st in stats if st["peak_bytes"] is not None]
    print(f"[machine] {tag}: host ms an instruction by unit "
          + ", ".join(f"{u} {ms:.3f} ({c})" for u, (c, ms) in sorted(units.items()))
          + f"; {max(st['ms'] for st in stats):.1f} ms, "
          f"{max(st['collective_ms'] for st in stats):.1f} ms inside collectives, "
          f"{max(st['bytes'] for st in stats) / 1e3:.1f} kB sent a rank, peak "
          f"{'n/a' if not peak else f'{max(peak) / 1e3:.1f} kB'} a rank; {smi}")


def _machine_sim(tag: str, programs: dict, params) -> None:
    """The same programs traced on the port's TraceMachine and replayed by
    ``sim.simulate`` on the cycle model of ``params``' lanes."""
    from repro_torch.core import isa_kernels
    from repro_torch.sim import TraceMachine, simulate

    for name, args in programs.items():
        tv = TraceMachine(params.vlen_bits, params.sew_bits, topology=params.topology)
        isa_kernels.KERNELS[name](tv, *args)
        r = simulate(tv.trace, params)
        print(f"[machine] {tag} sim {name} on a simulated {params.n_lanes}-lane "
              f"AraXL ({'x'.join(map(str, params.topology.shape))}, "
              f"{params.hierarchy}): {r.cycles:.0f} cycles, FPU util "
              f"{r.utilization:.3f}, {r.n_instrs} instructions")


def _machine_one_lane(dev, smi) -> None:
    """Phase 14a: a one-lane machine in this process on the card and on the
    CPU: every instruction (``check_core.exercise`` on 1,024-element
    registers, read after a first run) and the six programs at the card's Table I sizes
    (``check_core.PROGRAM_SIZES["card"]``), each against numpy and the card
    against the CPU (``check_core.held``: movement, masks and element-wise
    arithmetic bit for bit)."""
    import numpy as np
    import torch

    from repro_torch.core import make_machine
    from repro_torch.sim import araxl_params
    from repro_torch.testing import check_core as cc

    vlmax = MACHINE_VLEN_BITS // 64
    inp = cc.inputs(1, vl=vlmax)
    progs = cc.program_inputs(1, "card")
    want = cc.program_oracles(progs)
    runs = {}
    for d in (dev, torch.device("cpu")):
        v = make_machine(1, 1, vlen_bits=MACHINE_VLEN_BITS, dtype=torch.float64,
                         trace=[], device=d.type)
        assert v.device.type == d.type
        cc.exercise(v, inp, 1)                  # the first calls, not read
        # the peak above what the earlier phases left allocated
        base = torch.cuda.memory_allocated() if d.type == "cuda" else 0
        out, st = cc.measured(v, lambda c: cc.as_numpy(cc.to_host(
            cc.exercise(c, inp, 1))))
        cc.check(out, inp, 1, f"one lane {d.type}")
        got, pst = cc.measured(v, lambda c: cc.run_programs(c, progs))
        for r in (st, pst):
            if r["peak_bytes"] is not None:
                r["peak_bytes"] -= base
        for name, w in want.items():
            # check_core's 1e-10 relative, against the row's scale for the
            # elements near zero of a sum of products
            np.testing.assert_allclose(got[name], w, rtol=1e-10,
                                       atol=1e-10 * np.max(np.abs(w)),
                                       err_msg=f"{name} on {d.type}")
        runs[d.type] = (out, got)
        _machine_units(f"(a) one lane on {d.type}: every instruction", [st], smi)
        _machine_units(f"(a) one lane on {d.type}: the six programs", [pst], smi)
    bad = cc.held(runs["cuda"][0], runs["cpu"][0])
    cmp = cc.same(runs["cuda"][0], runs["cpu"][0])
    worst = {k: f"{r:.1e}" for k, (eq, r) in cmp.items() if not eq}
    print(f"[machine] (a) every instruction, card against CPU: "
          f"{len(cmp) - len(worst)} outputs bit-equal, the rest within {worst} "
          f"relative")
    if bad:
        raise AssertionError(f"(a) the card parts from the CPU in {bad}")
    for name in want:
        g, c = np.asarray(runs["cuda"][1][name]), np.asarray(runs["cpu"][1][name])
        np.testing.assert_allclose(g, c, rtol=1e-10, atol=1e-10 * np.max(np.abs(c)),
                                   err_msg=name)
        print(f"[machine] (a) {name} {np.shape(g)}: card against numpy "
              f"{np.max(np.abs(g - want[name])):.2e}, against the CPU "
              f"{np.max(np.abs(g - c)):.2e} (bit-equal {np.array_equal(g, c)})")
    _machine_sim("(a)", progs, araxl_params(1))


def _machine_ranks(smi, n: int, parts: str, tag: str) -> list:
    """``testing.check_core`` on ``n`` ranks sharing the card, then on ``n``
    CPU ranks (in turn: the host has 8 cores for them): every rank's
    assertions, the same bits on every rank, and the card's bit for bit the
    CPU's (``check_core.held``)."""
    from repro_torch.testing import check_core as cc
    from repro_torch.testing.subproc import run_ranks
    from repro_torch.testing.timing import now

    runs = {}
    for device in ("cuda", "cpu"):
        t0 = now()
        d = run_ranks("repro_torch.testing.check_core", n, str(n), "--parts", parts,
                      "--vlen-bits", str(MACHINE_VLEN_BITS), device=device,
                      timeout=600)
        runs[device] = cc.load(d, n)
        print(f"[machine] {tag} {n} ranks on {device}: every assertion held, "
              f"{now() - t0:.1f} s, spawns included")
    card, cpu = runs["cuda"], runs["cpu"]
    assert all(r["device"].startswith("cuda") for r in card)
    for part in parts.split(","):
        for key in card[0][part]:
            ex = card[0][part][key]
            if not (isinstance(ex, dict) and "out" in ex):
                continue
            outs = [cc.as_numpy(r[part][key]["out"]) for r in card]
            for r, o in enumerate(outs):
                bad = cc.held(o, cc.as_numpy(cpu[r][part][key]["out"]))
                if bad:
                    raise AssertionError(f"{tag} {key} rank {r}: card parts from "
                                         f"the CPU in {bad}")
                cross = [k for k, (eq, _) in cc.same(o, outs[0]).items()
                         if not eq and k not in ("reg", "reg_y", "reg2", "mask",
                                                 "brd2", "vid2")]
                if cross:
                    raise AssertionError(f"{tag} {key}: rank {r} differs from rank "
                                         f"0 in {cross}")
            _machine_units(f"{tag} {key}", [r[part][key]["stats"] for r in card], smi)
    return card


def _machine_path(dev, smi) -> None:
    """Phase 14: the paper's machine (``repro_torch.core``), f64 at VLEN 64
    Kibit: (a) one lane in this process; (b) eight ranks sharing the card,
    ``check_core``'s five configurations on (2, 4), (4, 2) and (2, 2, 2),
    ``check_topology``'s machines and ``check_collectives``' assertions;
    (c) sixteen ranks, AraXL-16 ((4, 4), two-level, staged, ring).  A
    functional run: lanes that share one card through host buffers say
    nothing of the machine's speed.  No kernel of
    the port launches on this path (its arithmetic is tensor ops, its
    movement ``comm``'s collectives)."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.parallel.comm import layout
    from repro_torch.sim import araxl_params
    from repro_torch.testing import check_core as cc
    from repro_torch.testing.timing import now

    t0 = now()
    before = dict(launches.LAUNCHES)
    _machine_one_lane(dev, smi)
    for n in MACHINE_RANKS:
        backend, transport = layout("cuda", n, torch.cuda.device_count())
        print(f"[machine] {n} ranks, {torch.cuda.device_count()} card: backend "
              f"{backend}, transport {transport}")
    card = _machine_ranks(smi, 8, "core,topology,collectives", "(b)")
    for g in ("2x4", "4x2", "2x2x2"):
        topo = cc.parse_grid(g)
        _machine_sim(f"(b) {g}", cc.program_inputs(8),
                     araxl_params(8, lanes_per_cluster=topo.lanes_per_cluster,
                                  n_pods=topo.shape[0] if topo.n_levels == 3 else None))
        _machine_units(f"(b) {g} the six programs",
                       [r["core"][(g, "programs_stats")] for r in card], smi)
    _machine_ranks(smi, 16, "flagship", "(c)")
    _, dot, rows = cc.flagship_inputs(MACHINE_VLEN_BITS // 64)
    _machine_sim("(c)", {"fdotproduct": dot, "softmax": rows}, araxl_params(16))
    if launches.LAUNCHES != before:
        raise AssertionError(f"a kernel launched on the machine's path: "
                             f"{launches.LAUNCHES} against {before}")
    print(f"[machine] phase 14 in {now() - t0:.1f} s; no kernel of the port "
          f"launched (counts unchanged); {smi}")


#: phase 15's table, in the checkout's build tree (made afresh each run)
TUNE_CACHE = ROOT / "build" / "autotune" / "cache.json"
#: readings earlier phases leave for phase 15 (peak device memory)
READINGS: dict = {}


def _serve_workload(model, dev) -> dict:
    """Phase 5's dense workload (8 requests of 32-256 tokens from seed 0, 16
    new tokens each, batch 4, 512 slots) through ``ServingEngine``: the
    streams by request, the launches and ``serve_launches``' count, decode
    ms a step (the engine's own spans) and the peak device memory."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    from repro_torch.train.trainer import serve_launches

    cfg = model.cfg
    engine = ServingEngine(model, ServeConfig(max_batch=4, max_seq=512), device=dev)
    prng = np.random.default_rng(0)
    plens = [int(n) for n in prng.integers(32, 257, 8)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for rid, n in enumerate(plens):
        engine.submit(Request(rid=rid, max_new_tokens=16,
                              prompt=prng.integers(1, cfg.vocab_size, n)))
    done = list(engine.run())
    tm = engine.timing
    return {"streams": {r.rid: list(r.out) for r in done},
            "launches": dict(ops.LAUNCHES),
            "want": serve_launches(cfg, tm["prefills"], tm["decode_steps"]),
            "decode_ms": 1e3 * tm["decode_s"] / tm["decode_steps"],
            "peak": torch.cuda.max_memory_allocated(), "engine": engine}


def _tooling_path(dev, smi) -> dict:
    """Phase 15: the tooling on the card.  (a) the autotuner at
    ``autotune.CASES`` (top-k 3, every candidate measured, so that the
    agreement at 3 reads the model) into ``TUNE_CACHE``: each signature's
    candidates with their model and measured us, the winner, its model rank
    and agreement, each measured candidate's error as a share of its limit
    (a candidate over its limit raises); the wgmma step and split costs the
    measured split counts fit, for the forward's 128 x 128 tile and the
    backward's 128 x 256, beside ``matmul.WGMMA_STEP_US`` and
    ``WGMMA_SPLIT_US`` (not changed).  (b) llama3-8b at full width and
    depth, phase 5's workload through the dense engine untuned, twice
    under ``tuned(TUNE_CACHE)`` and untuned again: the tuned streams the
    same bits twice, launches exactly ``serve_launches``, decode ms a step
    in turns, and a trace of four untuned decode steps.  (c) the dry run at
    the one-card geometry: llama3-8b's decode (batch 4, 512 slots) and
    train (8 layers, 4 x 1024, one microbatch) cells' predicted residency
    beside the measured peaks, the decode step's roofline beside its busy
    ms; then the production cell train_4k on pod16x16 (a fake process
    group of 256 ranks, in a process of its own) and its record.  (d)
    ``examples.serve_batch`` on the card, its streams equal to the CPU's.
    Returns the autotuner's launches (its checks against the plain
    versions not counted)."""
    import dataclasses
    import os

    import torch

    from repro_torch.configs import get_config
    from repro_torch.examples import serve_batch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.models import lm
    from repro_torch.params import init_params
    from repro_torch.serve import Request
    from repro_torch.testing.timing import now

    t_all = now()
    # -- (a) the autotuner ------------------------------------------------------
    if TUNE_CACHE.exists():
        TUNE_CACHE.unlink()
    ops.reset_launches()
    records = []
    t0 = now()
    with at.tuned(TUNE_CACHE, top_k=3, reps=5, warmup=1) as ctx:
        for kernel in at.KERNELS:
            for shape, dtype in at.CASES[kernel]:
                rec = at.autotune(kernel, shape, dtype, ctx=ctx, measure_all=True)
                records.append(rec)
                cands = "; ".join(
                    f"{e['config']} model {e['model_us']:.1f}"
                    + (f" measured {e['measured_us']:.1f} +- {e['iqr_us']:.1f} us, "
                       f"{e['limit_use']:.3f} of its limit" if "measured_us" in e else "")
                    for e in rec["candidates"])
                print(f"[tune] {kernel} {tuple(shape)} {dtype}: winner {rec['winner']} "
                      f"(default {at.default_config(kernel, shape, dtype)}), "
                      f"model rank {rec['model_rank_of_winner']}, agreement@3 "
                      f"{rec['agreement_at_k']}; {cands}")
    launches = dict(ops.LAUNCHES)
    print(f"[tune] launches on the autotuner's path (its checks against the plain "
          f"versions not counted): { {k: v for k, v in launches.items() if v} }")
    agree = sum(r["agreement_at_k"] for r in records)
    print(f"[tune] {len(records)} signatures in {now() - t0:.1f}s on {ctx.topology_tag}; "
          f"agreement@3 {agree} of {len(records)}; table {TUNE_CACHE}; each plan's calls "
          f"rotated through copies of its operands holding {at.ROTATE_BYTES / 2**20:.0f} "
          f"MiB (twice the L2: cold reads); {smi}")
    for trans, tile in ((0, "forward 128 x 128"), (1, "backward 128 x 256")):
        recs = [r for r in records if r["kernel"] == "matmul"
                and at._mm_dims(r["shape"])[3] == trans
                and kmm.variant(*at._mm_dims(r["shape"])[:3], torch.bfloat16,
                                trans=trans) == "wgmma"]
        fit = at.fit_wgmma_costs(recs)
        hand = kmm.WGMMA_STEP_US * kmm.wgmma_tile(trans)[1] / kmm.WGMMA_BN
        step = "not fitted" if fit["step_us"] is None else f"{fit['step_us']:.4f}"
        split = "not fitted" if fit["split_us"] is None else f"{fit['split_us']:.4f}"
        rms = "n/a" if fit["rms_us"] is None else f"{fit['rms_us']:.3f}"
        print(f"[tune] wgmma {tile}: fitted step {step} us a 64-deep K step, "
              f"split {split} us a further slice, over {fit['samples']} samples of "
              f"{len(fit['shapes'])} shapes (rms residual {rms} us); hand-set step "
              f"{hand:.2f} us (WGMMA_STEP_US {kmm.WGMMA_STEP_US} scaled by the "
              f"width), split {kmm.WGMMA_SPLIT_US} us; {smi}")

    # -- (b) llama3-8b under the table ---------------------------------------------
    cfg = get_config("llama3-8b")
    model = lm.Model(cfg, init_params(lm.model_defs(cfg),
                                      torch.Generator(dev).manual_seed(0), dev))
    base = _serve_workload(model, dev)
    engine = base.pop("engine")
    prompts = [r.prompt for r in engine.finished[:4]]
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=100 + rid, max_new_tokens=16, prompt=prompt))
    engine.step()
    tr = _trace(engine.step, 4)
    _print_trace(tr, 4, "untuned decode steps at batch 4")
    engine.run()
    del engine
    with at.tuned(TUNE_CACHE) as tctx:
        runs = [_serve_workload(model, dev) for _ in range(2)]
    if len(tctx.table) != len(records) or not tctx.hits:
        raise AssertionError(f"the tuned runs read {len(tctx.table)} entries of "
                             f"{TUNE_CACHE} ({len(records)} written) and took "
                             f"{tctx.hits} plans from it")
    print(f"[tooling] the tuned runs took {tctx.hits} launch plans from the table "
          f"({len(tctx.table)} entries)")
    last = _serve_workload(model, dev)          # untuned again: A, B, B, A
    for r in (*runs, last):
        r.pop("engine")
    same = runs[0]["streams"] == runs[1]["streams"]
    agree_tok = sum(a == b for rid in base["streams"] for a, b in
                    zip(base["streams"][rid], runs[0]["streams"][rid]))
    total_tok = sum(len(v) for v in base["streams"].values())
    print(f"[tooling] llama3-8b dense, phase 5's workload: tuned streams the same "
          f"bits twice: {same}; tuned tokens equal to untuned {agree_tok} of "
          f"{total_tok} (split plans change the f32 sums' order); decode ms/step "
          f"in turns untuned {base['decode_ms']:.2f}, tuned {runs[0]['decode_ms']:.2f} "
          f"and {runs[1]['decode_ms']:.2f}, untuned {last['decode_ms']:.2f} (host "
          f"clock; a reading, not a claim); untuned streams the same bits twice: "
          f"{base['streams'] == last['streams']}; peak {base['peak'] / 2**30:.2f} GiB; "
          f"{smi}")
    for r in (base, *runs, last):
        if r["launches"] != r["want"]:
            raise AssertionError(f"tooling serve launches {r['launches']}, expected "
                                 f"{r['want']}")
    if not same:
        raise AssertionError("the tuned streams differ between two runs")
    print(f"[tooling] launches of each run exactly serve_launches: {runs[0]['want']}")
    del model
    torch.cuda.empty_cache()

    # -- (c) the dry run ---------------------------------------------------------------
    dec = dr.analyse_cell(cfg, ShapeSpec("decode", 512, 4, "decode"), None, "one-card")
    t8 = dataclasses.replace(cfg, n_layers=8)
    trn = dr.analyse_cell(t8, ShapeSpec("train", 1024, 4, "train"), None, "one-card",
                          n_micro=1)
    gib = 2 ** 30
    p5 = READINGS.get("serve_peak")
    p7 = READINGS.get(("train_peak", cfg.name, 8))
    print(f"[dryrun] llama3-8b decode (batch 4, 512 slots, one card): arguments "
          f"{dec['mem_per_device']['arguments_gib']:.2f} GiB, predicted resident "
          f"{dec['mem_per_device']['resident_model_gib']:.2f} GiB; measured peak "
          f"{base['peak'] / gib:.2f} GiB (this phase's run of phase 5's workload)"
          + (f", {p5 / gib:.2f} GiB in phase 5" if p5 else ""))
    print(f"[dryrun] llama3-8b train (8 layers, 4 x 1024, one microbatch, one card): "
          f"arguments {trn['mem_per_device']['arguments_gib']:.2f} GiB, predicted "
          f"resident {trn['mem_per_device']['resident_model_gib']:.2f} GiB; measured "
          f"peak " + (f"{p7 / gib:.2f} GiB (phase 7)" if p7 else
                      "not measured in this run (phase 7 did not run)"))
    r = dec["roofline"]
    busy = tr["busy_us"] / 1e3 if tr["events"] else float("nan")
    bound_ms = 1e3 * max(r["compute_s"], r["memory_s"])
    print(f"[dryrun] decode step roofline: compute {1e3 * r['compute_s']:.4f} ms "
          f"({dec['per_device']['flops']:.4e} FLOP at {dr.HW['peak_flops']:.3e}/s), "
          f"memory {1e3 * r['memory_s']:.4f} ms (the analytic traffic model; the "
          f"unfused op count {1e3 * r['memory_s_hlo_upper']:.4f} ms); device busy "
          f"{busy:.3f} ms/step (the trace above): {bound_ms / busy:.3f} of busy is the "
          f"bound; {smi}")
    t0 = now()
    path = ROOT / "build" / "dryrun_torch" / "llama3-8b__train_4k__pod16x16.json"
    if path.exists():
        path.unlink()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "llama3-8b", "--shape", "train_4k", "--mesh", "single",
                          "--out", str(ROOT / "build" / "dryrun_torch")],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src"),
                              "CUDA_VISIBLE_DEVICES": ""})
    if out.returncode:
        raise AssertionError(f"the dry run of train_4k failed:\n{out.stdout[-3000:]}"
                             f"\n{out.stderr[-3000:]}")
    prod = json.loads(path.read_text())
    print(f"[dryrun] llama3-8b train_4k on pod16x16 (256 ranks on the fake backend, "
          f"host only, {now() - t0:.1f}s): {json.dumps(prod, sort_keys=True)}")

    # -- (d) the serve_batch twin, card against CPU ------------------------------------
    gpu = {r.rid: list(r.out) for r in serve_batch.main(["--device", "cuda"])}
    cpu = {r.rid: list(r.out) for r in serve_batch.main(["--device", "cpu"])}
    print(f"[tooling] serve_batch (mixtral-8x7b smoke, 8 requests at batch 4): "
          f"card streams equal the CPU's: {gpu == cpu}")
    if gpu != cpu:
        raise AssertionError(f"serve_batch streams differ: card {gpu}, cpu {cpu}")
    print(f"[tooling] phase 15 in {now() - t_all:.1f}s; {smi}")
    return launches


#: the parts ``--only`` runs alone: the libraries each builds, and what it
#: runs, given the device and the modules ``main`` imports
ONLY = {
    "matmul-bwd": (("matmul",),
                   lambda dev, m: _matmul_bwd_times(m.kc, m.kmm, m.ref, _time_ms)),
    "phi3": (("matmul", "rmsnorm", "flash_attention", "flash_attention_bwd"),
             lambda dev, m: (_phi3_path(dev),
                             _phi3_flash_times(m.kc, m.kfa, m.ref, _time_ms))),
    "moe": (("matmul", "rmsnorm", "flash_attention", "paged_attention"),
            lambda dev, m: _moe_path(dev)),
    "moe-train": (("matmul", "rmsnorm", "flash_attention", "flash_attention_bwd"),
                  lambda dev, m: _moe_train_path(dev)),
    "ssm": (("matmul", "rmsnorm"), lambda dev, m: (_ssm_smoke(dev), _ssm_path(dev))),
    "xattn": (("matmul", "rmsnorm", "flash_attention", "flash_attention_bwd"),
              lambda dev, m: (_xattn_checks(m.kc, m.kfa, m.kmm), _xattn_path(dev),
                              _xattn_times(m.kc, m.kfa, m.ref, _time_ms))),
    "state": (("matmul", "rmsnorm", "flash_attention", "flash_attention_bwd"),
              lambda dev, m: _state_path(dev)),
    "dist": (("matmul", "rmsnorm", "flash_attention", "flash_attention_bwd"),
             lambda dev, m: _dist_path(dev, m.smi)),
    "mesh": (("matmul", "rmsnorm", "flash_attention", "flash_attention_bwd",
              "paged_attention"), lambda dev, m: _mesh_path(dev, m.smi)),
    "machine": ((), lambda dev, m: _machine_path(dev, m.smi)),
    "f32": (("matmul", "flash_attention", "flash_attention_bwd"), _f32_part),
    "tooling": (("matmul", "rmsnorm", "flash_attention", "paged_attention",
                 "reduction", "stencil"), lambda dev, m: _tooling_path(dev, m.smi)),
}


def main(argv: list | None = None) -> int:
    import argparse
    import types

    ap = argparse.ArgumentParser(description="The port's smoke run on one CUDA card.")
    ap.add_argument("--only", choices=sorted(ONLY),
                    help="run one part alone (matmul-bwd: phase 6's matmul backward "
                         "rows; phi3: phase 7b and phase 6's phi3-mini flash rows; "
                         "moe: phase 8's serving; moe-train: phase 8's training; "
                         "ssm: phase 5's Mamba smoke models and phase 9; xattn: "
                         "phase 3's and 3c's cross-attention checks, phase 10 and "
                         "phase 6's cross-attention rows; f32: phase 6's f32 rows "
                         "3b, 3h and 2d; state: phase 11; dist: "
                         "phase 12; mesh: phase 13; machine: phase 14; tooling: "
                         "phase 15); "
                         "a copy of this file at the root of another checkout reads "
                         "that tree's kernels the same way")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'}; "
              "run it from the root of a checkout of the repo", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import reduction as kred
    from repro_torch.kernels import stencil as kst
    from repro_torch.serve import (PagedServeConfig, PagedServingEngine,
                                   Request, ServeConfig, ServingEngine, traffic)
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.testing.timing import now
    from repro_torch.train.trainer import serve_launches

    t_all = now()
    ends = []                               # (phase, s from the start at its end)
    ended = lambda phase: ends.append(f"{phase} {now() - t_all:.0f}")
    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[setup] allow_tf32 = False for matmul and cuDNN")

    # -- 1. device -----------------------------------------------------------
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.splitlines()[0])
    if args.only:
        libs, run = ONLY[args.only]
        _build.build(libs)
        out = run(dev, types.SimpleNamespace(kc=kc, kfa=kfa, kmm=kmm, ref=ref,
                                             smi=smi.splitlines()[0]))
        if args.only == "xattn" and out[0][1]:
            raise AssertionError(f"kernels disagree with their plain versions: "
                                 f"{out[0][1]}")
        return 0

    # -- 2. build ------------------------------------------------------------
    t0 = now()
    _build.build(CUDA_LIBS)                 # one nvcc each, all started together
    print(f"[build] {', '.join(f'{n}.cu' for n in CUDA_LIBS)} -> "
          f"{_build.BUILD_DIR} in {now() - t0:.1f}s")
    for lib in CUDA_LIBS:
        if lib != "matmul":                                     # each kernel by name
            for line in _ptxas_summary(_build.BUILD_LOGS.get(lib, "")):
                print(f"[build]   {lib}: {line}")
            continue
        for line in _build.BUILD_LOGS.get(lib, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {lib}: {line.strip()}")

    ended("2")
    # -- 3. kernels vs plain versions ------------------------------------------
    errs = {}
    failed = []
    for proj, (K, N) in kc.MATMUL_KN.items():
        for M in kc.MATMUL_M:
            for dt in (torch.bfloat16, torch.float32):
                r = kc.check_matmul(M, K, N, dt)
                errs[("matmul", M, K, N, dt)] = r["max_abs_err"]
                print(f"[check] matmul {proj:7s} M={M:<4d} K={K:<5d} N={N:<5d} "
                      f"{str(dt)[6:]:8s} {kmm.variant(M, K, N, dt):6s} same bits twice: "
                      f"{r['same_bits']} {_reading(r)}")
                if not r["ok"]:
                    failed.append(("matmul", proj, M, dt))
    for M, K, N, dt in kc.MATMUL_RAGGED:
        r = kc.check_matmul(M, K, N, dt)
        print(f"[check] matmul ragged  M={M:<4d} K={K:<5d} N={N:<5d} "
              f"{str(dt)[6:]:8s} {kmm.variant(M, K, N, dt):6s} same bits twice: "
              f"{r['same_bits']} {_reading(r)}")
        if not r["ok"]:
            failed.append(("matmul ragged", M, K, N, dt))
    for R in kc.RMSNORM_R:
        for dt in (torch.bfloat16, torch.float32):
            r = kc.check_rmsnorm(R, kc.D_MODEL, dt)
            errs[("rmsnorm", R, dt)] = r["max_abs_err"]
            print(f"[check] rmsnorm R={R:<4d} D={kc.D_MODEL} {str(dt)[6:]:8s} "
                  f"same bits twice: {r['same_bits']} {_reading(r)}")
            if not r["ok"]:
                failed.append(("rmsnorm", R, dt))
    # phi3-mini's widths (phase 7b's path): the matmul at each projection and
    # rmsnorm at its d_model, at a decode step's, the prefill's and the train
    # step's rows
    for proj, (K, N) in kc.PHI3_MATMUL_KN.items():
        for M in kc.PHI3_ROWS:
            for dt in (torch.bfloat16, torch.float32):
                r = kc.check_matmul(M, K, N, dt)
                errs[("matmul phi3", M, K, N, dt)] = r["max_abs_err"]
                print(f"[check] matmul phi3 {proj:7s} M={M:<4d} K={K:<5d} N={N:<5d} "
                      f"{str(dt)[6:]:8s} {kmm.variant(M, K, N, dt):6s} same bits twice: "
                      f"{r['same_bits']} {_reading(r)}")
                if not r["ok"]:
                    failed.append(("matmul phi3", proj, M, dt))
    for R in kc.PHI3_ROWS:
        for dt in (torch.bfloat16, torch.float32):
            r = kc.check_rmsnorm(R, kc.PHI3_D_MODEL, dt)
            errs[("rmsnorm phi3", R, dt)] = r["max_abs_err"]
            print(f"[check] rmsnorm phi3 R={R:<4d} D={kc.PHI3_D_MODEL} {str(dt)[6:]:8s} "
                  f"same bits twice: {r['same_bits']} {_reading(r)}")
            if not r["ok"]:
                failed.append(("rmsnorm phi3", R, dt))
    # mixtral-8x7b's expert products (phase 8's path) at each expert's buffer
    # rows: a decode step's, the 35-, 223- and 4,608-token prefills'
    for proj, (K, N) in kc.MOE_KN.items():
        for M in kc.MOE_M:
            for dt in (torch.bfloat16, torch.float32):
                r = kc.check_matmul(M, K, N, dt)
                errs[("matmul moe", M, K, N, dt)] = r["max_abs_err"]
                print(f"[check] matmul moe expert {proj:7s} M={M:<4d} K={K:<5d} "
                      f"N={N:<5d} {str(dt)[6:]:8s} {kmm.variant(M, K, N, dt):6s} same "
                      f"bits twice: {r['same_bits']} {_reading(r)}")
                if not r["ok"]:
                    failed.append(("matmul moe", proj, M, dt))
    for dt in (torch.bfloat16, torch.float32):
        r = kc.check_paged_attention(dt)
        errs[("paged_attention", dt)] = r["max_abs_err"]
        print(f"[check] paged_attention B={len(kc.PAGED_LENS)} Hkv={kc.HKV} "
              f"G={kc.HQ // kc.HKV} D={kc.HEAD_DIM} bt={kc.PAGED_BT} lens="
              f"{list(kc.PAGED_LENS)} {str(dt)[6:]:8s} "
              f"{kpa.plan(len(kc.PAGED_LENS), kc.HKV, kc.HQ // kc.HKV, kc.PAGED_NBLK * kc.PAGED_BT)} "
              f"{_reading(r)}")
        if not r["ok"]:
            failed.append(("paged_attention", dt))
        for case in kc.PAGED_CASES:
            r = kc.check_paged_case(case, dt)
            name, lens, G, D, bt, shared = case
            print(f"[check] paged_attention {name}: B={len(lens)} G={G} D={D} "
                  f"bt={bt}{' one table' if shared else ''} {str(dt)[6:]:8s} "
                  f"{r['plan']} same bits twice: {r['same_bits']} {_reading(r)}")
            if not r["ok"]:
                failed.append(("paged_attention", name, dt))
        for B, S, window in kc.FLASH_CASES:
            r = kc.check_flash_attention(S, dt, window, B=B)
            errs[("flash_attention", B, S, window, dt)] = r["max_abs_err"]
            print(f"[check] flash_attention B={B} Hq={kc.HQ} Hkv={kc.HKV} "
                  f"D={kc.HEAD_DIM} S={S:<4d} causal window={window} "
                  f"{str(dt)[6:]:8s} {r['variant']:5s} same bits twice: "
                  f"{r['same_bits']} {_reading(r)}")
            # bf16 and f32 at these heads through the tensor cores
            if not r["ok"] or r["variant"] != ("wgmma" if dt == torch.bfloat16 else "tf32x3"):
                failed.append(("flash_attention", B, S, window, dt))
        for D in kfa.HEAD_DIMS:
            for causal in (True, False):
                r = kc.check_flash_head_dim(D, causal, dt)
                print(f"[check] flash_attention B=2 Hq=4 Hkv=2 D={D:<3d} S=70 "
                      f"{'causal' if causal else 'full  '} window=9 "
                      f"{str(dt)[6:]:8s} {r['variant']:5s} {_reading(r)}")
                if not r["ok"]:
                    failed.append(("flash_attention head dim", D, causal, dt))
        # phi3-mini's heads (32 over 32 of 96) at a whole prompt: wgmma in
        # bf16, tf32x3 in f32
        S = kc.PHI3_FLASH_S
        r = kc.check_flash_phi3(S, dt)
        errs[("flash_attention phi3", S, dt)] = r["max_abs_err"]
        print(f"[check] flash_attention B=1 Hq={kc.PHI3_HQ} Hkv={kc.PHI3_HKV} "
              f"D={kc.PHI3_HEAD_DIM} S={S:<4d} causal window=None {str(dt)[6:]:8s} "
              f"{r['variant']:5s} same bits twice: {r['same_bits']} {_reading(r)}")
        if not r["ok"] or r["variant"] != ("wgmma" if dt == torch.bfloat16 else "tf32x3"):
            failed.append(("flash_attention phi3", S, dt))
    # -- 3c. the backward kernels vs plain versions -----------------------------
    bwd_errs, bwd_failed = _backward_checks(kc, kfa)
    errs.update(bwd_errs)
    failed += bwd_failed
    # the MoE training and Mamba2 paths' shapes (phases 8 and 9), forward
    # and backward
    fam_errs, fam_failed = _family_checks(kc, kmm)
    errs.update(fam_errs)
    failed += fam_failed
    # the cross-attention families' shapes (phase 10), forward and backward
    x_errs, x_failed = _xattn_checks(kc, kfa, kmm)
    errs.update(x_errs)
    failed += x_failed
    # -- 3b. the paper's Table I kernels vs plain versions -------------------------
    t1_errs, t1_failed = _table1_checks(kc)
    failed += t1_failed
    # expv on every f32 and bf16 bit pattern and at the round-half edges
    t0 = now()
    for what, r in kc.sweep_expv(kred.expv, ref.expv, dev).items():
        print(f"[sweep] expv kernel vs plain, {what}: {r['n']} inputs, {r['differ']} "
              f"differ in their bits, {r['nan_mismatch']} NaN on one side only, at "
              f"most {r['ulps']} ulp apart: {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failed.append(("expv sweep", what))
    print(f"[sweep] in {now() - t0:.1f}s")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    ended("3")

    # -- 4. smoke model: kernel path on the card vs plain path on the CPU ------
    scfg = get_smoke_config("llama3-8b")
    cpu_params = init_params(lm.model_defs(scfg),
                             torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    _smoke_dense(scfg, cpu_params, gpu_params, dev)
    _smoke_paged(scfg, cpu_params, gpu_params, dev)
    # -- 4b. smoke training: kernel path on the card vs plain path on the CPU --
    _smoke_train(dev)
    ended("4")

    # -- 5. main path: llama3-8b at full width, full depth --------------------
    cfg = get_config("llama3-8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = now()
    params = init_params(lm.model_defs(cfg), torch.Generator(dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    model = lm.Model(cfg, params)
    del params
    n_bytes = sum(t.numel() * t.element_size()
                  for t in model.state_dict().values())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers of {cfg.n_layers} "
          f"(full depth), d_model {cfg.d_model}, {str(cfg.dtype)[6:]}, "
          f"{n_bytes / 1e9:.2f} GB of weights, drawn in {now() - t0:.1f}s")
    engine = ServingEngine(model, ServeConfig(max_batch=4, max_seq=512),
                           device=dev)
    prng = np.random.default_rng(0)
    plens = [int(n) for n in prng.integers(32, 257, 8)]
    prompts = [prng.integers(1, cfg.vocab_size, n) for n in plens]
    ops.reset_launches()
    torch.cuda.synchronize()
    t_start = now()
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, max_new_tokens=16, prompt=prompt))
    done = list(engine.run())
    wall = now() - t_start
    launches = dict(ops.LAUNCHES)
    # the engine's own spans: prefills and decode steps, each ending on a
    # host read of tokens; TTFT from submit to the first token's read
    tm = engine.timing
    n_prefill, n_decode = tm["prefills"], tm["decode_steps"]
    prefill_s, decode_s = tm["prefill_s"], tm["decode_s"]
    ttft = [r.t_first - r.t_submit for r in done]
    # per forward, from the layer period (dense decode attention is plain
    # torch)
    want_launches = serve_launches(cfg, n_prefill, n_decode)
    prompt_toks = sum(plens)
    decode_toks = sum(len(r.out) - 1 for r in done)
    print(f"[serve] {len(done)} of 8 requests finished, prompts {plens}, "
          f"{sum(len(r.out) for r in done)} tokens generated, "
          f"{n_prefill} prefills + {n_decode} decode steps in {wall:.2f}s")
    print(f"[serve] prefill {prompt_toks / prefill_s:.1f} tok/s "
          f"({prompt_toks} tokens in {prefill_s:.3f}s); decode "
          f"{decode_toks / decode_s:.1f} tok/s ({decode_toks} tokens in "
          f"{n_decode} steps, {1e3 * decode_s / n_decode:.2f} ms/step); "
          f"p50 TTFT {1e3 * float(np.median(ttft)):.1f} ms "
          f"(all 8 submitted at once, 4 slots)")
    READINGS["serve_peak"] = torch.cuda.max_memory_allocated()
    print(f"[serve] launches {launches} (expected {want_launches}); "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(done) != 8 or any(not r.out for r in done):
        raise AssertionError("not every request finished")
    if any(t >= cfg.vocab_size for r in done for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    if launches != want_launches:
        raise AssertionError(f"dense path launches {launches} over {n_prefill} "
                             f"prefills + {n_decode} decode steps, expected "
                             f"{want_launches}")
    path_launches = {"dense": launches}

    # -- 5b. where a decode step's device time goes --------------------------
    # four fresh requests fill the 4 slots; the first step admits them, the
    # timed and traced steps are pure decode at batch 4
    n_trace = 4
    for rid, prompt in enumerate(prompts[:4]):
        engine.submit(Request(rid=100 + rid, max_new_tokens=3 * n_trace + 4,
                              prompt=prompt))
    engine.step()
    _print_trace(_trace(engine.step, n_trace), n_trace, "decode steps at batch 4")
    engine.run()
    if not all(r.done for r in engine.finished):
        raise AssertionError("a traced request did not finish")
    _, logits = lm.prefill(engine.params,
                           torch.as_tensor(done[0].prompt, device=dev)[None],
                           cfg, 512)
    if logits.shape != (1, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"bad logits {logits.shape}")
    # where a whole-prompt prefill's device time goes: the longest prompt
    longest = torch.as_tensor(prompts[int(np.argmax(plens))], device=dev)[None]

    def prefill_once():
        _, lg = lm.prefill(engine.params, longest, cfg, 512)
        lg[0, -1, 0].item()              # a host read, as the engine's
    _print_trace(_trace(prefill_once, 2), 2,
                 f"whole-prompt prefills of {longest.shape[1]} tokens")
    del engine, logits
    torch.cuda.empty_cache()

    # the Mamba family's smoke models, card against CPU, through the dense
    # engine
    _ssm_smoke(dev)

    # -- 5c. the paged path: llama3-8b at full width, full depth --------------
    # the same weights; a 513-block pool (block 0 the zero block) of 16-token
    # blocks, 8 slots of up to 1024 tokens; open-loop traffic over a Zipf pool
    # of 8 synthetic prompts at the full vocabulary
    lc = traffic.LoadConfig(n_requests=16, rate_rps=PAGED_RATE, zipf_a=1.1,
                            pool_size=8, min_prompt=64, max_prompt=512,
                            max_new=32, vocab_size=cfg.vocab_size, seed=0)
    pool_prompts = traffic.prompt_pool(lc)
    print(f"[paged] open loop: {lc.n_requests} requests at {lc.rate_rps} req/s "
          f"(Poisson), Zipf({lc.zipf_a}) over {lc.pool_size} prompts of "
          f"{[len(p) for p in pool_prompts]} tokens, {lc.max_new} new tokens "
          f"each; max_batch 8, max_seq 1024, block_tokens 16, n_blocks 512")
    paged_case = None
    for tag, chunk in (("paged", 0), ("paged_chunked", 128)):
        peng = PagedServingEngine(model, PagedServeConfig(
            max_batch=8, max_seq=1024, block_tokens=16, n_blocks=512,
            chunk=chunk), device=dev)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        m = traffic.run_open_loop(peng, lc)
        got = dict(ops.LAUNCHES)
        tm = peng.timing
        n_pf, n_ch, n_dec = tm["prefills"], tm["chunks"], tm["decode_steps"]
        want = serve_launches(cfg, n_pf, n_dec, chunks=n_ch, paged=True)
        done_p = peng.finished
        dec_toks = sum(len(r.out) - 1 for r in done_p)
        print(f"[paged] {tag}: {m['completed']} of {lc.n_requests} completed in "
              f"{m['wall_s']:.2f}s; TTFT p50 {m['ttft_p50_ms']:.1f} ms, p99 "
              f"{m['ttft_p99_ms']:.1f} ms; {m['decode_tok_s']:.1f} tok/s "
              f"generated over the run; decode {dec_toks / tm['decode_s']:.1f} "
              f"tok/s, {1e3 * tm['decode_s'] / n_dec:.2f} ms/step over {n_dec} "
              f"steps; occupancy {m['occupancy']}, max concurrent "
              f"{m['max_concurrent']}")
        print(f"[paged] {tag}: {n_pf} whole prefills ({tm['prefill_s']:.3f}s), "
              f"{n_ch} chunks ({tm['chunk_s']:.3f}s); shared_hits "
              f"{peng.alloc.shared_hits}, cow_copies {peng.cow_copies}, "
              f"prefill_chunks {peng.prefill_chunks}; peak resident KV "
              f"{peng.kv_bytes_resident_peak()} bytes ({peng.alloc.peak_allocated} "
              f"blocks); max_memory_allocated {torch.cuda.max_memory_allocated()} "
              f"bytes (since this engine's run began)")
        print(f"[paged] {tag}: launches {got} (expected {want})")
        if m["completed"] != lc.n_requests or len(done_p) != lc.n_requests:
            raise AssertionError(f"{tag}: not every request finished")
        if any(not r.out or max(r.out) >= cfg.vocab_size for r in done_p):
            raise AssertionError(f"{tag}: a token outside the vocabulary")
        if got != want:
            raise AssertionError(f"{tag}: launches {got}, expected {want}")
        if chunk and not n_ch or not chunk and (n_ch or not peng.alloc.shared_hits):
            raise AssertionError(f"{tag}: chunks {n_ch}, shared_hits "
                                 f"{peng.alloc.shared_hits}")
        _check_pool(peng)
        path_launches[tag] = got
        if not chunk:
            # -- 5d. where a paged decode step's device time goes ------------
            # eight pool prompts fill the 8 slots; the first step admits them
            for rid, prompt in enumerate(pool_prompts):
                peng.submit(Request(rid=200 + rid, prompt=prompt,
                                    max_new_tokens=3 * n_trace + 4))
            peng.step()
            _print_trace(_trace(peng.step, n_trace), n_trace,
                         "decode steps at batch 8")
            # the next step's attention inputs, kept for phase 6: every
            # layer's pool view, the tables and the lens
            paged_case = {
                "views": [(lv["k"][i].permute(2, 0, 1, 3), lv["v"][i].permute(2, 0, 1, 3))
                          for lv in (peng.pool[k]["s0_attn"] for k in peng.pool)
                          for i in range(cfg.n_periods)],
                "tables": torch.from_numpy(peng.tables.copy()).to(dev),
                "lens": torch.from_numpy(peng.slot_pos + 1).to(dev)}
            peng.run()
            _check_pool(peng)
        del peng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()

    ended("5")
    # -- 5e. the Table I path: both configurations through ops -------------------
    path_launches["table1"] = _table1_path(kc, ops, ref, dev)
    ended("5e")

    # -- 7. the training path: llama3-8b at full width, 8 of 32 layers -------
    path_launches["train"] = _train_path(cfg, dev)
    ended("7")
    # -- 7b. phi3-mini at full width, 2 of 32 layers: head dim 96 --------------
    path_launches.update(_phi3_path(dev))
    ended("7b")
    # -- 8. the MoE family: mixtral-8x7b at full width, 24 of 32 layers --------
    path_launches["moe"] = _moe_path(dev)
    # ... and its training at full width, 2 of 32 layers
    path_launches["moe_train"] = _moe_train_path(dev)
    ended("8")
    # -- 9. the Mamba2 family: mamba2-370m at full width and depth -------------
    path_launches.update(_ssm_path(dev))
    ended("9")
    # -- 10. the cross-attention families: llama-3.2-vision-11b, seamless ------
    path_launches.update(_xattn_path(dev))
    ended("10")
    # -- 11. state and resilience: llama3-8b resumes; the chaos harnesses -------
    path_launches["state"] = _state_path(dev)
    ended("11")
    # -- 12. distributed compute: four ranks share the card ---------------------
    path_launches["dist"] = _dist_path(dev, smi.splitlines()[0])
    ended("12")
    # -- 13. state and serving on a mesh: eight ranks share the card ------------
    path_launches["mesh"] = _mesh_path(dev, smi.splitlines()[0])
    ended("13")
    # -- 14. the paper's machine: one rank a lane, 1, 8 and 16 lanes ------------
    _machine_path(dev, smi.splitlines()[0])
    ended("14")
    # -- 15. the tooling: the autotuner on the card, the dry run, serve_batch -------
    path_launches["tooling"] = _tooling_path(dev, smi.splitlines()[0])
    ended("15")

    # -- 6. kernel times ---------------------------------------------------------
    time_ms = _time_ms

    rows, device_rows = {}, {}
    for proj, (K, N) in kc.MATMUL_KN.items():
        for M in kc.MATMUL_M:
            for dt in (torch.bfloat16, torch.float32):
                a, b = kc.matmul_inputs(M, K, N, dt)
                # cycle through copies of the weight totalling > 2x the 50 MB
                # L2, so each launch finds it cold, as the model's layers do
                nb = max(1, min(8, math.ceil(100e6 / (b.numel() * b.element_size()))))
                bs = [b.clone() for _ in range(nb)]
                it = [0]

                def pick():
                    it[0] += 1
                    return bs[it[0] % nb]
                iters = 20 if M * K * N > 1e10 else 50
                t_k = time_ms(lambda: kmm.matmul(a, pick()), iters)
                t_p = time_ms(lambda: ref.matmul(a, pick()), iters)
                t_l = time_ms(lambda: torch.matmul(a, pick()), iters)
                kind = "bf16" if dt == torch.bfloat16 else "f32"
                isz = a.element_size()
                bound, by = _ms_bound((M * K + K * N + M * N) * isz,
                                      2.0 * M * N * K, kind)
                rows[("matmul", M, K, N, dt)] = (t_k, t_p, t_l, bound, by)
                # between events, back-to-back calls of a small shape time the
                # host's launches; the trace gives the card's own time a call
                d_k = _device_call(lambda: kmm.matmul(a, pick()), 20)
                d_l = _device_call(lambda: torch.matmul(a, pick()), 20)
                device_rows[("matmul", M, K, N, dt)] = (d_k, d_l)
                print(f"[time] matmul {proj:7s} M={M:<4d} K={K:<5d} N={N:<5d} "
                      f"{kind:4s} {kmm.variant(M, K, N, dt):6s} kernel {t_k:.4f} ms  "
                      f"plain {t_p:.4f} ms  torch.matmul {t_l:.4f} ms  "
                      f"bound {bound:.4f} ms ({by}); device: kernel {d_k:.4f} ms, "
                      f"torch.matmul {d_l:.4f} ms, {d_k / d_l:.2f}x torch.matmul, "
                      f"{d_k / bound:.2f}x bound")
                del a, b, bs
    # the wgmma split plan against every count it may take, at the prefill
    # shapes where it splits: device ms a call (the plan's cost model,
    # WGMMA_STEP_US a K step and WGMMA_SPLIT_US a further slice, is read
    # from these); each count forced by lifting the plan's choice to it
    plan_knobs = (kmm.WGMMA_MAX_SPLITS, kmm.WGMMA_SPLIT_US)
    for M, K, N in ((128, 4096, 1024), (128, 4096, 4096), (128, 14336, 4096),
                    (223, 14336, 4096), (333, 4096, 1024)):
        a, b = kc.matmul_inputs(M, K, N, torch.bfloat16)
        chosen = kmm.wgmma_plan(M, K, N)[0]
        by_count = []
        for n in range(1, plan_knobs[0] + 1):
            kmm.WGMMA_MAX_SPLITS, kmm.WGMMA_SPLIT_US = n, 0.0
            kmm.wgmma_plan.cache_clear()
            kmm.matmul(a, b)
            by_count.append((kmm.wgmma_plan(M, K, N)[0],
                             _device_call(lambda: kmm.matmul(a, b), 20)))
        kmm.WGMMA_MAX_SPLITS, kmm.WGMMA_SPLIT_US = plan_knobs
        kmm.wgmma_plan.cache_clear()
        print(f"[time] matmul wgmma split plan M={M} K={K} N={N}: device ms by "
              f"slices " + ", ".join(f"{n}: {t:.4f}" for n, t in by_count)
              + f"; the plan takes {chosen}")
    # each variant's host cost a call: back-to-back calls at K = N = 64, where
    # the kernel takes a few us, between events (torch.matmul beside it)
    for M, dt in ((4, torch.bfloat16), (16, torch.bfloat16), (4, torch.float32)):
        a, b = kc.matmul_inputs(M, 64, 64, dt)
        t_k = time_ms(lambda: kmm.matmul(a, b), 500)
        t_l = time_ms(lambda: torch.matmul(a, b), 500)
        print(f"[time] matmul host cost M={M} K=64 N=64 {str(dt)[6:]:8s} "
              f"{kmm.variant(M, 64, 64, dt):6s} {1e3 * t_k:.1f} us a call "
              f"(torch.matmul {1e3 * t_l:.1f} us)")
    for R in kc.RMSNORM_R:
        for dt in (torch.bfloat16, torch.float32):
            x, g = kc.rmsnorm_inputs(R, kc.D_MODEL, dt)
            g_lib = g.to(dt)
            D = kc.D_MODEL
            t_k = time_ms(lambda: krms.rmsnorm(x, g, kc.EPS), 200)
            t_p = time_ms(lambda: ref.rmsnorm(x, g, kc.EPS), 200)
            t_l = time_ms(lambda: torch.nn.functional.rms_norm(
                x, (D,), g_lib, kc.EPS), 200)
            kind = "bf16" if dt == torch.bfloat16 else "f32"
            bound, by = _ms_bound(2 * R * D * x.element_size() + 4 * D,
                                  4.0 * R * D, "f32")
            rows[("rmsnorm", R, dt)] = (t_k, t_p, t_l, bound, by)
            # between events, back-to-back calls time the host's launches;
            # a trace gives the card's own time a call
            d_k, d_l = (_device_call(f, 50) for f in (
                lambda: krms.rmsnorm(x, g, kc.EPS),
                lambda: torch.nn.functional.rms_norm(x, (D,), g_lib, kc.EPS)))
            device_rows[("rmsnorm", R, dt)] = (d_k, d_l)
            print(f"[time] rmsnorm R={R:<4d} D={D} {kind:4s} kernel {t_k:.4f} ms  "
                  f"plain {t_p:.4f} ms  F.rms_norm {t_l:.4f} ms  "
                  f"bound {bound:.5f} ms ({by}); device: kernel {d_k:.4f} ms, "
                  f"F.rms_norm {d_l:.4f} ms")
    # rmsnorm's host cost a call at the decode shape: back-to-back calls
    # between events, in turns with F.rms_norm (kernel, library, library,
    # kernel)
    x, g = kc.rmsnorm_inputs(4, kc.D_MODEL, torch.bfloat16)
    g_lib = g.to(torch.bfloat16)
    fk = lambda: krms.rmsnorm(x, g, kc.EPS)
    fl = lambda: torch.nn.functional.rms_norm(x, (kc.D_MODEL,), g_lib, kc.EPS)
    host = {"kernel": [], "library": []}
    for turn, fn in (("kernel", fk), ("library", fl), ("library", fl), ("kernel", fk)):
        host[turn].append(1e3 * time_ms(fn, 500))
    print(f"[time] rmsnorm host cost R=4 D={kc.D_MODEL} bf16, us a call in turns: "
          "kernel " + " / ".join(f"{t:.1f}" for t in host["kernel"])
          + "; F.rms_norm " + " / ".join(f"{t:.1f}" for t in host["library"]))
    device_rows[("rmsnorm", "host")] = host

    # flash attention at whole-prompt lengths (bf16, the model's dtype: the
    # dense path's 37 and 223, the paged path's 445, and 512; f32 at the
    # longest in _f32_rows), beside SDPA on the same causal GQA function:
    # between events, and the device's own ms a call from a trace of each
    Hq, Hkv, D = kc.HQ, kc.HKV, kc.HEAD_DIM
    for S, dt in ((37, torch.bfloat16), (223, torch.bfloat16), (445, torch.bfloat16),
                  (512, torch.bfloat16)):
        q, k, v = kc.flash_inputs(S, dt)
        iters = 50 if S > 100 else 200
        kern = lambda: kfa.flash_attention(q, k, v, causal=True)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        t_k = time_ms(kern, iters)
        t_p = time_ms(lambda: ref.attention(q, k, v, causal=True), iters)
        t_l = time_ms(sdpa, iters)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        var = kfa.variant(S, S, D, dt)
        d_k, d_l = _device_call(kern, 20), _device_call(sdpa, 20)
        # q and out once, k and v once; 4 D operations per visible (q, k) pair
        bound, by = _ms_bound(q.element_size() * S * D * (2 * Hq + 2 * Hkv),
                              4.0 * D * Hq * S * (S + 1) / 2, kind)
        rows[("flash_attention", S, dt)] = (t_k, t_p, t_l, bound, by)
        device_rows[("flash_attention", S, dt)] = (d_k, d_l)
        print(f"[time] flash_attention B=1 Hq={Hq} Hkv={Hkv} D={D} S={S:<4d} "
              f"causal {kind:4s} {var:5s} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
              f"SDPA {t_l:.4f} ms  bound {bound:.5f} ms ({by}); device: kernel "
              f"{d_k:.4f} ms, SDPA {d_l:.4f} ms, {d_k / d_l:.2f}x SDPA, "
              f"{d_k / bound:.1f}x bound")
    del q, k, v
    # phi3-mini's heads (32 over 32 of 96), forward and backward
    phi3_rows = _phi3_flash_times(kc, kfa, ref, time_ms)
    # each variant's host cost a call: back-to-back calls at 2 q heads of 16
    # rows, where each kernel takes a few us, between events, in turns; the
    # same bf16 inputs through each variant (the choice forced by lifting
    # `variant` to it), so the difference is the wgmma launch's own (its three
    # tensor maps encoded a call), and SDPA beside them
    q, k, v = (torch.randn((1, 16, h, D), device=dev).to(torch.bfloat16)
               .transpose(1, 2) for h in (2, 1, 1))
    chooser, host = kfa.variant, {}
    for turn in ("wgmma", "simt", "simt", "wgmma"):
        kfa.variant = lambda *a, _v=turn, **kw: _v
        host.setdefault(turn, []).append(
            1e3 * time_ms(lambda: kfa.flash_attention(q, k, v, causal=True), 500))
    kfa.variant = chooser
    t_l = 1e3 * time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 500)
    print(f"[time] flash_attention host cost B=1 Hq=2 Hkv=1 S=16 D={D} bf16, us a "
          f"call in turns: " + "; ".join(f"{n} " + " / ".join(f"{t:.1f}" for t in ts)
                                        for n, ts in host.items())
          + f" (SDPA {t_l:.1f})")

    # paged attention at the traced batch-8 decode step's inputs, cycling
    # over the 32 layers' pools so each launch finds its K/V cold in L2, as
    # a decode step does; no one PyTorch call computes it
    views, tables, lens = (paged_case[k] for k in ("views", "tables", "lens"))
    B, nb = tables.shape
    G = Hq // Hkv
    q = torch.randn((B, Hkv, G, D), generator=torch.Generator(dev).manual_seed(0),
                    device=dev).to(torch.bfloat16)
    r = kc.compare(kpa.paged_attention(q, *views[0], tables, lens),
                    ref.paged_attention(q, *views[0], tables, lens),
                    kc.ATTN_TOL[torch.bfloat16])
    it = [0]

    def pick():
        it[0] += 1
        return views[it[0] % len(views)]
    t_k = time_ms(lambda: kpa.paged_attention(q, *pick(), tables, lens), 128)
    t_p = time_ms(lambda: ref.paged_attention(q, *pick(), tables, lens), 32)
    d_k, n_d = _device_ms(lambda: kpa.paged_attention(q, *pick(), tables, lens),
                          PORT_KERNELS["paged_attention"], 64)
    paged_plan = kpa.plan(B, Hkv, G, nb * views[0][0].shape[2])
    n_tok = int(lens.sum())
    bound, by = _ms_bound(n_tok * Hkv * D * 2 * 2 + 2 * q.numel() * 2
                          + tables.numel() * 4 + B * 4,
                          4.0 * n_tok * Hkv * G * D, "bf16")
    # the host's cost a call alone: back-to-back calls on one sequence of one
    # token (a few us of device time), between events
    one = (q[:1], *views[0], tables[:1], torch.ones(1, dtype=torch.int32, device=dev))
    paged_host = [1e3 * time_ms(lambda: kpa.paged_attention(*one), 500) for _ in range(2)]
    rows[("paged_attention",)] = (t_k, t_p, None, bound, by)
    errs[("paged_attention",)] = r["max_abs_err"]
    device_rows[("paged_attention",)] = (d_k, None)
    print(f"[time] paged_attention B={B} Hkv={Hkv} G={G} D={D} bt=16 lens="
          f"{lens.tolist()} bf16 {paged_plan} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
          f"(no one-call PyTorch counterpart)  bound {bound:.5f} ms ({by}); device: "
          f"kernel {d_k:.4f} ms (mean of {n_d} in a trace of 64 calls), "
          f"{d_k / bound:.1f}x bound; against plain: {_reading(r)}")
    print(f"[time] paged_attention host cost B=1 lens=[1] bf16, us a call: "
          + " / ".join(f"{t:.1f}" for t in paged_host))
    if not r["ok"]:
        raise AssertionError("paged_attention disagrees at the decode inputs")
    t1_rows = _table1_times(kc, kred, kst, ref, time_ms, dev)
    bwd_rows = _backward_times(kc, kfa, kmm, krms, ref, time_ms)
    f32_rows = _f32_rows(kc, kfa, kmm, ref, time_ms)
    xattn_rows = _xattn_times(kc, kfa, ref, time_ms)

    # the decode-step shapes, where serving spends most of its time, and the
    # longest whole-prompt prefill; launches summed over the four main paths
    total = {k: sum(pl[k] for pl in path_launches.values())
             for k in ops.LAUNCHES}
    kernels = []
    for kname, key, err_key, route, source, replaces, shape in (
            ("matmul", ("matmul", 4, 4096, 14336, torch.bfloat16), None, "cuda",
             "src/repro_torch/kernels/csrc/matmul.cu",
             "src/repro/kernels/matmul.py:84", "M=4,K=4096,N=14336,bf16"),
            ("rmsnorm", ("rmsnorm", 4, torch.bfloat16), None, "cuda",
             "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:44", "R=4,D=4096,bf16"),
            ("flash_attention", ("flash_attention", 512, torch.bfloat16),
             ("flash_attention", 1, 512, None, torch.bfloat16), "cuda",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:118",
             "B=1,Hq=32,Hkv=8,S=512,D=128,causal,bf16"),
            ("paged_attention", ("paged_attention",), None, "cuda",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:104",
             f"B={B},Hkv=8,G=4,D=128,bt=16,tokens={n_tok},bf16")):
        t_k, t_p, t_l, bound, by = rows[key]
        kernels.append({"name": kname, "route": route, "source": source,
                        "replaces": replaces, "launches": total[kname],
                        "launches_by_path": {p: pl[kname] for p, pl
                                             in path_launches.items()},
                        "max_abs_err": errs[err_key or key], "ms": t_k,
                        "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                        "library_ms": t_l, "shape": shape})
        if kname == "matmul":            # f32 at the prefill shape (row 2d)
            kernels[-1]["f32"] = f32_rows["2d"]
        if kname == "matmul":            # the prefill regime beside decode's
            p_k, p_p, p_l, p_bound, p_by = rows[("matmul", 333, 4096, 14336,
                                                 torch.bfloat16)]
            kernels[-1]["prefill"] = {
                "shape": "M=333,K=4096,N=14336,bf16", "ms": p_k, "plain_ms": p_p,
                "library_ms": p_l, "bound_ms": p_bound, "bound_by": p_by,
                "max_abs_err": errs[("matmul", 333, 4096, 14336, torch.bfloat16)],
                "device_ms": device_rows[("matmul", 333, 4096, 14336,
                                          torch.bfloat16)][0],
                "library_device_ms": device_rows[("matmul", 333, 4096, 14336,
                                                  torch.bfloat16)][1]}
            kernels[-1]["device_ms"], kernels[-1]["library_device_ms"] = \
                device_rows[key]
        if kname in ("flash_attention", "rmsnorm"):
            kernels[-1]["device_ms"], kernels[-1]["library_device_ms"] = \
                device_rows[key]
        if kname == "flash_attention":   # phi3-mini's head dim, cross-attention, f32
            key3 = ("flash_attention phi3", kc.PHI3_FLASH_S, torch.bfloat16)
            kernels[-1]["phi3"] = {**phi3_rows["fwd"], "max_abs_err": errs[key3]}
            kernels[-1]["f32"] = {**f32_rows["3b"], "kernels": [
                PORT_KERNELS["flash_attention tf32x3 split"],
                PORT_KERNELS["flash_attention tf32x3"]]}
            kernels[-1]["cross"] = {n: r["fwd"] for n, r in xattn_rows.items()}
            kernels[-1]["cross"]["max_abs_err"] = max(
                v for k, v in errs.items() if k[0] == "flash_attention cross")
        if kname == "paged_attention":
            kernels[-1]["device_ms"] = device_rows[key][0]
            kernels[-1]["host_us"] = paged_host
            kernels[-1]["plan"] = paged_plan._asdict()
        if kname == "rmsnorm":
            kernels[-1]["host_us"] = device_rows[("rmsnorm", "host")]
    # the Table I kernels at table1-card (table1-paper beside them)
    for kname, key, err_key, source, replaces in (
            ("dotprod", ("dotprod", kc.TABLE1["table1-card"]["dot"]),
             ("dot", kc.TABLE1["table1-card"]["dot"]), "reduction.cu",
             "src/repro/kernels/reduction.py:58"),
            ("expv", ("expv", kc.TABLE1["table1-card"]["dot"]),
             ("expv", kc.TABLE1["table1-card"]["dot"]), "reduction.cu",
             "src/repro/kernels/reduction.py:103"),
            ("softmax_rows", ("softmax_rows", kc.TABLE1["table1-card"]["softmax"][0]),
             ("softmax", kc.TABLE1["table1-card"]["softmax"][0]), "reduction.cu",
             "src/repro/kernels/reduction.py:197"),
            ("jacobi2d", ("jacobi2d", kc.TABLE1["table1-card"]["jacobi"]),
             ("jacobi", kc.TABLE1["table1-card"]["jacobi"]), "stencil.cu",
             "src/repro/kernels/stencil.py:42"),
            ("fconv2d", ("fconv2d", kc.TABLE1["table1-card"]["conv"]),
             ("conv", kc.TABLE1["table1-card"]["conv"]), "stencil.cu",
             "src/repro/kernels/stencil.py:78")):
        t_k, t_p, t_l, bound, by, shape, c_d, c_ld = t1_rows[(kname, "table1-card")]
        p_k, p_p, p_l, p_bound, _, p_shape, p_d, p_ld = t1_rows[(kname, "table1-paper")]
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}",
                        "replaces": replaces, "launches": total[kname],
                        "launches_by_path": {p: pl[kname] for p, pl
                                             in path_launches.items()},
                        "max_abs_err": t1_errs[err_key], "ms": t_k,
                        "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                        "library_ms": t_l, "shape": f"table1-card {shape},f32",
                        "table1_paper": {"shape": p_shape, "ms": p_k,
                                         "device_ms": p_d, "plain_ms": p_p,
                                         "library_ms": p_l,
                                         "library_device_ms": p_ld,
                                         "bound_ms": p_bound}})
        if (kname, "host") in t1_rows:
            kernels[-1]["table1_paper"]["host_us"] = t1_rows[(kname, "host")]
        if not math.isnan(c_d):
            kernels[-1]["device_ms"], kernels[-1]["library_device_ms"] = c_d, c_ld
    # the backward kernels at the training shapes (the matmul's at wg/wi, the
    # other projections beside it)
    for kname, src, replaces, err_key in (
            ("rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:44",
             ("rmsnorm_bwd", kc.TRAIN_TOKENS, kc.D_MODEL, torch.bfloat16)),
            ("matmul_bwd", "matmul.cu", "src/repro/kernels/matmul.py:84",
             ("matmul_bwd", "b", kc.TRAIN_TOKENS, 4096, 14336, torch.bfloat16)),
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:118",
             ("flash_attention_bwd", 4, 1024, None, torch.bfloat16))):
        row = bwd_rows[kname]
        if kname == "matmul_bwd":
            row = {**row["wg/wi"], "projections": row}
        if kname == "flash_attention_bwd":   # phi3-mini's head dim, cross-attention, f32
            row = {**row, "f32": {**f32_rows["3h"], "kernels": [
                       PORT_KERNELS["flash_attention_bwd dq tf32x3"],
                       PORT_KERNELS["flash_attention_bwd dkv tf32x3"]]},
                   "phi3": {**phi3_rows["bwd"], "max_abs_err":
                                   errs[("flash_attention_bwd phi3", *kc.PHI3_FLASH_BWD,
                                         torch.bfloat16)]},
                   "cross": {**{n: r["bwd"] for n, r in xattn_rows.items()},
                             "max_abs_err": max(v for k, v in errs.items()
                                                if k[0] == "flash_attention cross")}}
        if kname == "matmul_bwd":
            worst = max(errs[("matmul_bwd", w, kc.TRAIN_TOKENS, 4096, 14336,
                              torch.bfloat16)] for w in "ab")
        else:
            worst = errs[err_key]
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": replaces, "launches": total[kname],
                        "launches_by_path": {p: pl[kname] for p, pl
                                             in path_launches.items()},
                        "max_abs_err": worst, **row})
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel never launched on the main paths: {total}")
    ended("6")
    print(f"[done] chip_smoke.py in {now() - t_all:.1f}s; each phase ended at (s): "
          + ", ".join(ends))
    print(json.dumps({"kernels": _json_numbers(kernels)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
