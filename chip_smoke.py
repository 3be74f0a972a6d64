#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) serves
Moby (one stream and a fleet), serves and trains the dense LMs and the
moe family (moonshot-v1-16b-a3b; deepseek-v2-236b with MLA), serves the
vlm family (qwen2-vl-2b, M-RoPE) and the audio family (whisper-small's
encoder, cross attention and decode), and serves and trains the
PointPillars detector on an NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels flash_attention,pillar_scatter

With ``--kernels`` it builds and runs phase 3 for the named kernels only
(their checks, times and profiles) and stops there, printing no result
line: a short bring-up call for a kernel being worked on.

Needs one CUDA card, ``nvcc`` (the kernels build from ``src/repro_torch/csrc``
on first use) and ``nvidia-smi``; imports nothing of JAX or of the JAX
package ``repro``. It exits non-zero, before printing any result, when torch
sees no card or the port's sources are not beside the script. Phases, each
fatal on failure:

1. the card's name and power limit, torch and CUDA versions;
2. the kernel build (``nvcc`` for ``sm_90a``, one process per source),
   timed;
3. the launch floor (a one-element ``zero_()`` timed as the kernels are),
   then each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes (and a few others: K1 ``point_proj``'s two
   instances, uv, depth, visible and flat (``point_proj``) and the labels
   alone (``point_proj_labels``, the serving path's launch), each bit for
   bit at 122,880 points, at an unaligned base (a points view 12 bytes
   past a 16-byte boundary), at N = 77, the
   full one also at 1,000,003 points, the labels one also on kitti-urban
   frame 0's own points, instance-id image and calibration (timed too,
   its visible share printed), and with a stream axis (points (S, N, 3),
   label images (S, H, W): the fleet's one launch a frame) bit for bit
   against the plain version and, stream by stream, the 2-D kernel, at
   the three fleets' shapes (timed: the full-width fleet's 16 x 122,880
   points, fleet-16-congested, fleet-64-mixed), S = 1 and a ragged S = 3;
   K2 ``iou2d`` bit for bit at 24x12, 130x250,
   1x1 and on each side of its one-CTA limit (32x32, 33x33), and with a
   stream axis ((S, T, 4) x (S, D, 4), the same two checks) at the
   fleets' shapes (timed: 16 x 24x12, 16 x 16x8, 64 x 12x6), S = 1, S = 3
   at 33x33 and S = 64 at 130x250; K3
   ``ransac_score`` also at
   one point and one plane, with an object of invalid points, at 4,000
   points an object and at the fleets' S x O objects (timed: 192, 128 and
   384 objects); the attention kernels in f32 at
   2e-5, and in bf16 against the plain version's f32 result on the same
   bf16 inputs, each value within half a bf16 ulp, plus, for the
   tensor-core flash route, which rounds p to bf16 for its P.V product, an
   allowance for that rounding; see ``attention_close``; the worst
   difference over its limit is printed for every case), flash attention
   once per route (``flash_attention``: the 3xTF32 kernel, f32, and bf16
   at hd 16 and 32, timed at LM B's shape and, in f32, at LM C's prefill
   shape; ``flash_attention_tc``: the bf16 tensor-core kernel, hd 128,
   timed at LM C's prefill shape and at MoE C's, where moonshot's 16 query
   heads have a kv head each, and hd 64, timed at zamba2-1.2b's prefill
   (32 heads, a kv head each) with whisper-small's encoder and cross
   attention checked; decode attention timed at LM C's decode
   shape and at MoE C's, G = 1 too; both also at G = 1 on small ragged
   cases, and at the ported configs' G = 3, 6, 16 and 48 (minitron-4b,
   qwen2-vl, glm4-9b, granite-20b); both timed at VLM C's shapes (G = 6)
   and at Audio C's (flash: whisper's encoder, 16 x 1,500 frames, its
   decoder's self attention, 227 causal, and cross attention, 227 over
   1,500; decode, the bf16 hd-64 instance: the 448 self cache, ragged
   with an empty request, and the 1,500 cross caches, every position
   live); flash attention at MLA's head dims, qk 192 / value 128: the
   tensor-core route at MLA C's prefill shape (128 heads, S 8192, timed,
   its plain version 8 heads at a time), a ragged tile and full
   attention, the 3xTF32 route in f32 at MLA B's shape (its persistent
   instance; timed, and at B 1, S 2048), full attention, runs of ragged
   items, and at SMOKE's 24 / 16 in f32 and bf16 (each timed, and a
   ragged tile); the MLA
   decode kernel (``mla_decode_attention``, no Pallas counterpart: the
   einsums of JAX's absorbed decode) at MLA C's decode shape (B 16, 128
   heads, (R, P) = (512, 64), a 32k compressed cache, ragged lengths;
   timed), with lengths 1, S_max and off the tile and run boundaries,
   100 heads with an empty request, its tf32x3 instance (f32) at MLA B's
   decode shape and its SIMT one at SMOKE's (16, 8) (both timed), in bf16
   at (16, 8), in f32 with ragged lengths (timed), 100 heads with an empty
   request, more requests than runs and one request over every run, then
   the tensor-core instance at 64 heads (a cluster of one CTA), 65,
   one request of 32,768 positions, 64 short ragged requests and an empty
   request between live ones; each bf16 case with the P-rounding
   allowance, its library yardstick SDPA on [q_lat | q_rope],
   [ckv | krope] and ckv as one head of H queries), then timed with CUDA
   events after a warm-up:
   device time per call from replays of a CUDA graph of up to 50 calls
   (median of 20), and the eager per-call time; the attention kernels'
   plain versions eagerly (a few calls: the flash one holds a 4.3 GB score
   tensor at the prefill shape), and PyTorch's
   ``scaled_dot_product_attention`` on the same inputs as their library
   yardstick (timed here, used nowhere in the port; the kernels it ran
   are named from a profile); the two attention gradients, K5's on both
   routes of ``fa_ops.route`` (``flash_attention_bwd``, the 3xTF32
   tensor-core kernel: LM T's shape in f32 and at hd 64 in bf16, LM T's
   f32 correctness shape, G = 1, 2, 3, 4, 8 and 16, Sq = Sk = 1, 77, 256
   and 4096, causal and not, every head dim in f32 and in bf16,
   keys longer than queries, and at MLA's qk 192 / value 128 in f32 (MLA
   T's correctness shape, timed) and 24 / 16 in f32 and bf16 (MLA A's
   shape, both timed); ``flash_attention_bwd_tc``, the bf16
   tensor-core kernel: LM T's bf16 shape, Sq = Sk = 1, a ragged 77 with
   contiguous operands, keys longer than queries, full attention at S
   256, S 1024 causal, and at qk 192 / value 128 MLA T's shape (128
   heads, S 4096, timed; its plain version 8 heads at a time) and
   moonshot's MoE T shape at hd 128 (G = 1, timed); at G = 1 either
   route's direct write of dK and dV held bit for bit to the partials'
   group sum (``group_sum_path``); ``decode_attention_bwd``: the decode
   shape with
   ragged positions and an empty request, f32 GQA and MQA, SMOKE's head
   dim, 3, 16 and 48 query heads a kv head; every case of the three called
   twice and the two results equal bit for bit), f32 within 2e-5 of the
   gradient's scale (flash attention's computed in float64), bf16 within
   half a bf16
   ulp + 2e-5 rel + 1e-6 of the plain gradient computed in float64 on the
   same bf16 inputs, plus, for the tensor-core
   route, which rounds P and dS to bf16 as operands of its products,
   ``P_ROUNDING`` times each value's rounding term (``grads_close``,
   ``bwd_rounding_terms``), timed beside SDPA's autograd backward; K4
   ``pillar_scatter`` forward (equal by
   value) and backward (bit for bit) at Det B's shape (the real pillar ids
   of a kitti-urban frame at 122,880 points), dense collisions, all points
   masked out, planted ties, special values, every point in one pillar,
   points sorted by pillar, rows of 7 and of 40 channels and rows at an
   unaligned base, beside ``scatter_reduce(..., "amax")`` and autograd's
   gradient of it, with each direction's passes timed from a profile; the
   auction kernel (no Pallas counterpart: JAX's ``lax.while_loop``
   auction) bit for bit in the assignment, the prices and the rounds
   against its plain version, with the assignment's total benefit within
   n x 1e-4 of the optimum (``hungarian_numpy``'s up to 128 persons,
   SciPy's ``linear_sum_assignment`` above, the two held equal at 129), on
   the benefits of a kitti-urban transform frame and of the full-width
   fleet's transform branch (both recorded from the serving path on the
   card, both timed, its plain version eagerly, as it synchronises, with
   the time of a round and of a skeleton of the same rounds that only
   synchronises the warp and tests for the end, and a bound from the
   bidders' rows alone, the bidders of each round counted by a replay of
   the plain rounds), seeded benefits on the
   1e-3 grid with many exact ties at n = 1, 2, 12, 16, 24, 31, 32, 33, 40,
   64 and the row instances' cap (128) with batch 1, 16, 64 and 256, rows
   and columns of zeros, every row equal (all persons bid on one object)
   and all zeros, each of these timed too (device ms and us a round; the
   plain version too at n = 40 and 128, one auction); its wide instance
   (``auction_wide``, n > 128) the same way on the benefits of a
   kitti-urban transform frame with max_obj = 80 (n = 160, recorded on
   the card, measured in full) and on seeded tied benefits at n = 129,
   160, 256, 512 and 1024 (batch 1 and 16), at the card's resident bound
   and one past it (its two tiers, ``auction.ops.plan``), rows and columns
   of zeros and every row equal at n = 160 and 256, these at 20,000 rounds
   a phase (their ties need more than 4,000 from n = 512), each timed with
   the wide skeleton of its rounds (the instance's CTA barriers and end
   test alone);
4. the Moby serving path at KITTI's own size (``kitti-urban`` at 122,880
   points and a 375x1242 image, 24 frames) on the card, with every
   kernel's launch count checked against the run's frame kinds (K1's
   labels instance once a transform frame and its full instance never,
   K2 and the auction once a frame, K3 once a transform frame), after a
   2-frame warm-up; then a torch.profiler window over 4 frames (device busy
   share, device ops per frame, the ops with the most device time);
5. the same run on the CPU in this process: frame kinds equal, floats within
   the golden tolerance; then kitti-urban at KITTI's size with max_obj = 80
   (auctions of n = 160 persons: the wide instance once a frame, the row
   instances never, checked) on the card after a warm-up, 6 frames, held
   to its CPU run the same way, its median wall ms a frame (all frames,
   transform, anchor) in the kernel line's ``auction_wide`` entry
   (``serve_wide_ms``); then the observability hooks on the card
   (``Session(obs=ObsConfig(...))``): kitti-urban, 8 frames, unobserved,
   with metrics and the trace, and with every switch on, each counting
   its synchronising CUDA calls under ``set_sync_debug_mode("warn")``: the
   observed reports equal the unobserved one bit for bit, metrics and the
   trace add no synchronisation (fatal), the all-on run's audit rows and
   modelled trace lanes equal its CPU run's at the golden tolerance; the
   medians of the host spans ``moby/transform_step`` (the host's enqueue)
   and ``moby/frame_stats_fetch`` (its wait on the card) beside the
   transform frame's wall ms, observed and not; fleet-16-congested
   orchestrated with every switch on (4 frames, bit for bit with its
   unobserved run, audit rows, cloud and uplink records) and in scan mode
   with metrics and the trace (the first ``fleet/scan_dispatch`` span
   marked compiled: the graph capture), scan mode's refusal of the audit;
   one ``{"observability": ...}`` JSON line;
6. the fleet, orchestrated mode (``api.Session`` builds the port's
   ``FleetEngine`` for ``n_streams > 1``): ``fleet-16-congested`` (8
   frames), ``fleet-64-mixed`` (6 frames; TX2/Orin edges, a 4-GPU cloud
   pool), each as the preset defines it, and the full-width fleet,
   ``kitti-urban`` with 16 streams at KITTI's own size on the ``fcc1``
   cell (4 frames: its tapes take ~9 s of host time a frame, and the
   whole run has to fit its time limit), each after a 2-frame warm-up,
   its tapes recorded
   before the timed run; the launches checked per fleet frame (K1's
   labels instance 1, K2 and the auction 2: the anchor and the transform
   branch, K3 1, the others 0); wall ms per fleet frame and per
   stream-frame (median),
   the share spent copying the frame's inputs to the card, peak device
   memory; a torch.profiler window over 2 frames of the full-width fleet;
   each run held to the port's CPU run of the same preset in this
   process (the full-width fleet's first 2 frames): kinds exact, floats
   within the golden tolerance; one ``{"fleets": [...]}`` JSON line;
   then the same three fleets in scan mode (``run(scan=True)``: the tape
   copied to the card once, one frame of the body captured in a CUDA
   graph and replayed a frame under sync debug mode "error", one fetch),
   each after a warm-up: the captured frame's launches checked (as a
   fleet frame's), replays of a second capture bit for bit against the
   same body run eagerly on the card, a profiled replay window (busy
   share, device ops a fleet frame, each kernel's launches by name), wall
   ms a fleet frame and a stream-frame, the tape's copy, warm-up and
   capture times, peak memory, and the rows held to the port's CPU scan
   (the full-width fleet's first 2 frames); ``fleet-256-congested`` (4
   frames) against ``tests/goldens/fleet-256-congested-scan.csv`` (stream,
   frame, kind, device exact; the modelled times at the golden tolerance)
   and, every column, against its CPU scan; one ``{"scans": [...]}`` JSON
   line;
7. the ``smoke`` preset on the card against ``tests/goldens/smoke.csv``;
8. LM A, the card against JAX: qwen2.5-3B SMOKE in f32 with the weights of
   ``tests/goldens/lm_qwen2_5_3b_smoke.npz``, prefill and four decode
   steps within 1e-5 of the golden's logits;
9. LM B, the card against the port's CPU run at full width: qwen2.5-3B with
   2 of its 36 layers in f32 (attention weights rescaled so the scores are
   of order 1, see ``rescale_attention``), prefill at B=2, S=256 and four
   decode steps (max_len 512), logits within 1e-4; the launches of A and B
   checked (the 3xTF32 flash route and decode attention, one a layer);
10. LM C, serving qwen2.5-3B at full width (36 layers, bf16, seeded random
   weights drawn a layer at a time): prefill at B=1, S=8192 (median of 3
   after a warm-up) and 32 greedy decode steps at B=16 over a
   32,768-position cache filled from a seeded generator with ragged
   positions, every kernel's launch count checked (the bf16 tensor-core
   flash route 36 per prefill and the 3xTF32 route none, decode 36 per
   step), one step under sync debug mode "error"; ms per prefill and per
   step, decode tokens/s, peak device memory, and a torch.profiler window
   over 4 decode steps (LM A-C run through ``check_family`` and
   ``serve_family``, as VLM and Audio A-C below);
10b. MoE A, the card against JAX: moonshot-v1-16b-a3b SMOKE in f32 with
   the weights of ``tests/goldens/lm_moonshot_v1_16b_a3b_smoke.npz``,
   prefill and four decode steps within 1e-5 of the golden's logits;
10c. MoE B, the card against the port's CPU run at full width: moonshot
   with 2 of its 48 layers (the dense first layer and one MoE layer) in
   f32, attention weights rescaled as LM B's, prefill at B=2, S=256 and
   four decode steps, logits within 1e-4, every token routed to the same
   experts on both (the smallest gap between a token's k-th and (k+1)-th
   router probability printed); launches of A and B checked (the 3xTF32
   flash route and decode attention, one a layer);
10d. MoE C, serving moonshot at full width in bf16 (seeded random weights)
   at 12 of its 48 layers (1 dense + 11 MoE, what one card holds beside
   LM C's KV cache) with LM C's traffic: prefill at B=1, S=8192 (median
   of 3 after a warm-up; its routing's expert loads and drops printed)
   and 32 greedy decode steps at B=16 over a 32,768-position cache,
   launches checked (the tensor-core flash route 12 a prefill, decode 12
   a step, the rest 0), one step under sync debug mode "error" (no
   synchronising call), ms per prefill and per step, tokens/s, peak
   memory, and torch.profiler windows over a prefill and 4 steps;
10e. MLA A, the card against JAX: deepseek-v2-236b SMOKE in f32 with
   the weights of ``tests/goldens/lm_deepseek_v2_236b_smoke.npz``,
   prefill and four decode steps within 1e-5 of the golden's logits; then
   in bf16 (SMOKE's own dtype; K5's ``tf32x3`` bf16 (24, 16) instance)
   against the port's CPU run of the same weights, within 3e-2 of the
   logits' scale (``tests/test_torch_mla.py``'s bf16 tolerance);
10f. MLA B, the card against the port's CPU run at full width:
   deepseek-v2 with 2 of its 60 layers (the dense first layer and one MoE
   layer of 160 experts) in f32, MLA weights rescaled (``rescale_mla``),
   prefill at B=2, S=256 and four decode steps, logits within 1e-4, the
   routing equal (the smallest top-k gap printed); launches of A and B
   checked (the 3xTF32 flash route at MLA's head dims, one a layer a
   prefill, and the MLA decode kernel one a layer a step, counted by
   instance: the SIMT one in A, the tf32x3 one in B);
10g. MLA C, serving deepseek-v2 at full width in bf16 (seeded weights,
   drawn a layer at a time) at 8 of its 60 layers (1 dense + 7 MoE,
   29.19B parameters) with LM C's traffic: prefill at B=1, S=8192 (median
   of 3 after a warm-up; expert loads and drops printed) and 32 greedy
   decode steps at B=16 over a 32,768-position compressed cache, launches
   checked (the tensor-core flash route at qk 192 / value 128, 8 a
   prefill, the MLA decode kernel 8 a step, the rest 0), one step under
   sync debug mode "error", ms per prefill and per step, tokens/s, peak
   memory, and torch.profiler windows over a prefill and 4 steps (the
   MLA decode kernel's share of a step's device time);
10h-10m. VLM A-C and Audio A-C (``check_family``, ``serve_family``):
   qwen2-vl-2b (the vlm family: prefill from embeddings at M-RoPE
   positions (3, B, S) of text, an image and text, ``mrope_positions``)
   and whisper-small (the audio family: the encoder over the frames'
   embeddings, the decoder's self and cross attention; decode over the
   self cache and cross caches that the run seeds, since no code fills
   them, as in JAX). A: SMOKE in f32 with the weights and inputs of
   ``tests/goldens/lm_qwen2_vl_2b_smoke.npz`` /
   ``lm_whisper_small_smoke.npz``, prefill and four decode steps within
   1e-5 of the golden's logits; B: full width with 2 layers (whisper: 2
   encoder + 2 decoder layers) in f32, attention rescaled (the cross
   attention too), prefill at B=2, S=256 (qwen2-vl: 64 text, an 8x16
   image, 64 text; whisper: all 1,500 frames) and four decode steps
   against the port's CPU run within 1e-4; launches of A and B checked
   (the 3xTF32 flash route, decode attention); C: every layer in bf16
   (seeded weights): qwen2-vl-2b with LM C's traffic (prefill B=1,
   S=8192: 2,048 text, a 64x64 image, 2,048 text; 32 decode steps at
   B=16 over a 32k cache), whisper-small with its own (16 requests of
   1,500 frames and a 227-token decoder prefill, whisper's longest
   initial sequence; 32 steps at B=16 over a 448 self cache, ragged,
   and seeded cross caches), launches checked (K5 `tc` 28 / 36 a prefill, K6 28 / 24 a step), one step under sync debug
   mode "error", ms a prefill and a step, tokens/s, peak memory, a
   profile of 4 steps;
11. LM T, training qwen2.5-3B on the card: gradients reach q, k, v and
   the caches through the backward kernels (bf16 flash on the tensor-core
   route, f32 on the 3xTF32 one, decode; each counter up by one, the same
   values as the kernels called directly; fatal: F3); the bf16 GEMM's
   gradient at LM T's MLP shape held to JAX's arithmetic (F4:
   ``check_matmul_grad``); full width with
   2 layers in f32 (LM B's rescaled weights) at B=2, S=256: the loss and
   every gradient, a ``make_train_step`` step and one with
   ``grad_accum=2`` (the CPU's half of a step takes ~10 s) against the
   same on the CPU in this process, within
   1e-4 of the values' scale (the parameters also within the sum of the
   steps' learning rates, AdamW's move of an entry whose gradient is near
   eps), the ``tf32x3`` gradient launched once a layer a backward pass
   (counted: the kernel JSON line's ``flash_attention_bwd`` launches are
   these and ``fit``'s); 36 layers in bf16 over f32 master weights,
   ``remat="full"``, at B=1, S=4096 (cut from the 32k context so the f32
   AdamW state fits beside the logits): a warm-up step, then 4 steps
   timed by CUDA events, ms a step, tokens/s, peak memory, launches a step
   checked (the tensor-core flash route 72: forward and remat's
   recompute, its tensor-core gradient 36, the rest 0), a profile over 2
   steps naming the attention kernels' device time a step; ``fit`` at the
   SMOKE config in f32,
   checkpoints every 2 steps, cut after 4 and resumed: losses equal to the
   uncut run's bit for bit;
11b. MoE T and MLA T, training the moe family on the card: the experts'
   batched bf16 GEMM's gradient (``_BmmF32Out``) at moonshot's expert
   shape held to JAX's arithmetic (F4, ``check_bmm_grad``); deepseek-v2
   SMOKE (qk 24 / value 16) in f32, seeded and rescaled: the loss, every
   gradient and 3 train steps against the CPU (1e-4), and in bf16 its
   loss and logits within 3e-2 of the CPU's (``train_smoke``); then each
   of moonshot (MoE T) and deepseek-v2 (MLA T) at full width
   (``train_moe``): f32 correctness at B=2, S=256 on the card against the
   CPU within 1e-4 (moonshot at 2 layers, the dense one and a MoE layer:
   the loss, every gradient, 3 steps and one with grad_accum 2;
   deepseek-v2 at 1, its dense MLA layer: the loss, every gradient and a
   step), the routing equal; timed in bf16 over f32 masters, remat
   "full", B=1, S=4096: moonshot at 6 layers, AdamW steps, deepseek-v2 at
   2 layers (the dense one and a 160-expert MoE layer), loss-and-gradient
   passes (AdamW's state does not fit beside them); a warm-up whose
   recomputed forward (remat) routes every token as the first did, then 3
   counted steps or passes by CUDA events: ms, tokens/s, expert loads and
   drops, peak memory, launches checked (the tensor-core flash route 2 a
   layer, its gradient 1), a profile of 2;
12. Det A, the card against JAX: the PointPillars detector at a small
   config (32x32 pillars) with the weights and frame of
   ``tests/goldens/det3d_smoke.npz``: forward, loss, every gradient,
   detect and three AdamW steps at the CPU parity tests' tolerances;
13. Det B, the detector at full width (128x128 pillars, feat 32, backbone
   (32, 64, 128), seeded random weights) on 24 kitti-urban frames at
   122,880 points: detect per frame and 8 training steps (loss, backward,
   AdamW) after a warm-up, K4's launches checked (one forward a forward
   pass, one backward a step), peak device memory, a torch.profiler window
   over 4 detect calls; then 2 frames on the CPU against the card;
14. one ``{"kernels": [...]}`` JSON line (an entry a kernel, and one for
   each instance at MLA's dims and the gradient's at moonshot's G = 1:
   ``INSTANCES``), the card line again, and last the ``{"ok": true,
   "device": ...}`` line.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "goldens" / "smoke.csv"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# the float32 rate outside the tensor cores and the dense bf16 and TF32
# tensor rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_TF32_PER_S = 495e12
# exp2 on the special-function units: 16 a clock an SM (the CUDA
# programming guide's throughput table, compute capability 9.0) on 132 SMs
# at the 1.83 GHz that the 989 TFLOP/s bf16 rate implies.
EXP2_PER_S = 16 * 132 * 1.83e9

# The golden CSV tolerance (tests/test_goldens.py).
RTOL, ATOL = 1e-4, 1e-5
FLOAT_COLS = ("latency_s", "onboard_s", "f1", "precision", "recall")

KITTI = dict(n_points=122880, img_h=375, img_w=1242)
KITTI_FRAMES = 24

# The fleet phase: the two fleet presets as they are defined, and the
# full-width fleet: 16 kitti-urban vehicles at KITTI's own size on the
# congested fcc1 cell. (name, scenario overrides, frames on the card,
# frames of the CPU run it is held to, timing keys of its phase-3 cases.)
FLEETS = (
    ("fleet-16-congested", {}, 8, 8, "fleet_16"),
    ("fleet-64-mixed", {}, 6, 6, "fleet_64"),
    ("kitti-urban", dict(n_streams=16, trace="fcc1", **KITTI), 4, 2,
     "fleet_kitti"),
)
FLEET_WARMUP, FLEET_PROFILE_FRAMES = 2, 2
# The kernels of the Moby serving path (one stream, a fleet, scan mode).
MOBY_KERNELS = ("point_proj", "point_proj_labels", "iou2d", "ransac_score",
                "auction", "auction_wide")
# The single-stream path past 128 persons an auction: kitti-urban at KITTI's
# size with max_obj = 80 (n = 160), on the card and on the CPU.
WIDE_MAX_OBJ, WIDE_FRAMES = 80, 6
# The observability phase: kitti-urban (single stream) and
# fleet-16-congested frames observed on the card.
OBS_FRAMES, OBS_FLEET_FRAMES = 8, 4

# LM serving, qwen2.5-3B at full width. The repo's prefill_32k (S 32768,
# batch 32) and decode_32k (batch 128) shapes are cut to what one card
# holds beside the weights: see PERF.md.
LM_ARCH = "qwen2_5_3b"
LM_GOLDEN = ROOT / "tests" / "goldens" / "lm_qwen2_5_3b_smoke.npz"
PREFILL_B, PREFILL_S = 1, 8192
DECODE_B, DECODE_MAX, DECODE_STEPS = 16, 32768, 32
DECODE_POS_LO = 8192
# LM B: full width with 2 layers in f32, prefill at B 2, S 256 (the 3xTF32
# flash route's shape on the main path).
LM_B_BATCH, LM_B_S, LM_B_LAYERS = 2, 256, 2
# LM T, training qwen2.5-3B at full width (36 layers, bf16 over f32 master
# weights, AdamW, remat "full"): B 1, S 4096, cut from the model's 32k
# context so the f32 AdamW state (~49 GB) fits beside the logits. A
# warm-up step, then T_STEPS timed steps; the correctness steps are LM B's
# shape (2 layers, f32) against the CPU.
T_BATCH, T_SEQ, T_STEPS = 1, 4096, 4
# The attention kernels whose device time LM T's profile names: the
# forward (tensor-core route) and the three launches of its gradient.
T_PROFILED = ("flash_tc_kernel", "dq_tc_kernel", "dkv_tc_kernel",
              "reduce_tc_kernel")

# The moe family: moonshot-v1-16b-a3b at full width (64 routed experts,
# top-6, 2 shared, a dense first layer; MHA at hd 128, so K5 `tc` and K6 run
# at one query head a kv head). MoE A holds SMOKE to its JAX golden, MoE B
# full width x 2 layers (the dense one and one MoE layer) in f32 to the CPU,
# MoE C serves 12 layers (1 dense + 11 MoE: 7.22B parameters, 14.4 GB in
# bf16 beside a 51.5 GB KV cache at LM C's decode shape; all 48 layers are
# 56.8 GB in bf16 and do not fit beside it) with LM C's traffic.
MOE_ARCH = "moonshot_v1_16b_a3b"
MOE_GOLDEN = ROOT / "tests" / "goldens" / "lm_moonshot_v1_16b_a3b_smoke.npz"
MOE_B_LAYERS, MOE_C_LAYERS = 2, 12
# MLA: deepseek-v2-236b at full width (MLA with q_lora 1536 and a 512 + 64
# latent cache, 128 heads of qk dim 192 / value dim 128; 160 routed
# experts, top-6, 2 shared, a dense first layer). MLA A holds SMOKE to its
# JAX golden, MLA B full width x 2 layers (the dense one and one MoE layer)
# in f32 to the CPU, MLA C serves 8 layers (1 dense + 7 MoE: 29.19B
# parameters, 58.4 GB in bf16, beside a 4.83 GB compressed cache at LM C's
# decode shape; 9 layers would leave no room for the prefill) with LM C's
# traffic.
MLA_ARCH = "deepseek_v2_236b"
MLA_GOLDEN = ROOT / "tests" / "goldens" / "lm_deepseek_v2_236b_smoke.npz"
MLA_B_LAYERS, MLA_C_LAYERS = 2, 8
# MoE T and MLA T, training the moe family at full width. Correctness in
# f32 at LM B's shape, the card against the CPU: moonshot at 2 layers (the
# dense first layer and one MoE layer: 1.345B parameters), deepseek-v2 at
# 1 (the dense first layer with MLA: 1.387B; its MoE layer would add
# 3.97B, past what the card and the host hold in f32 with AdamW's state).
# Timed in bf16 over f32 masters, remat "full", at LM T's B=1, S=4096:
# moonshot at 6 of its 48 layers (3.696B parameters: f32 masters,
# gradients and both AdamW moments are 59.1 GB) with AdamW steps;
# deepseek-v2 at 2 of its 60 (the dense first layer and one MoE layer:
# 5.359B parameters), loss-and-gradient passes only, since AdamW's 16
# bytes a parameter (85.7 GB) pass one 80 GB card (the parameters and
# gradients alone are 42.9 GB). A warm-up, then TM_STEPS timed.
MOE_T_CHECK_LAYERS, MOE_T_LAYERS = 2, 6
MLA_T_CHECK_LAYERS, MLA_T_LAYERS = 1, 2
TM_STEPS = 3

# The vlm and audio families, serving. VLM: qwen2-vl-2b (hd 128, 12 heads
# over 2 kv heads: K5 `tc` and K6 at G = 6), its prefill from embeddings at
# M-RoPE positions (3, B, S) of text, an image of (rows, cols) patches and
# text (``mrope_positions``): VLM B 64 + 8 x 16 + 64 = 256 positions, VLM C
# 2,048 + 64 x 64 + 2,048 = 8,192 (LM C's prefill) and LM C's decode.
# Audio: whisper-small (hd 64, 12 heads a kv head each; 12 encoder and 12
# decoder layers), the encoder over all 1,500 frames and cross attention
# over them (K5 `tc` at (64, 64), not causal), decode over its self cache
# and seeded cross caches (K6 bf16 at hd 64). Audio C takes whisper's own
# traffic: 16 requests of 1,500 frames, each prefilling the longest
# initial sequence whisper's decoding builds, 227 tokens (openai/whisper,
# whisper/decoding.py, DecodingTask._get_initial_tokens: sot_prev, the
# previous text's last n_text_ctx // 2 - 1 = 223 tokens, then the
# 3-token sot sequence), and a self cache of n_text_ctx = 448 positions
# (its learned decoder table's length; the repo's 32k RoPE shape is not
# whisper's). A holds SMOKE to its JAX golden, B full width x
# LM_B_LAYERS layers (audio: 2 + 2) in f32 to the CPU, C serves every
# layer in bf16 (``check_family``, ``serve_family``, as LM A-C).
VLM_ARCH, AUDIO_ARCH = "qwen2_vl_2b", "whisper_small"
VLM_GOLDEN = ROOT / "tests" / "goldens" / "lm_qwen2_vl_2b_smoke.npz"
AUDIO_GOLDEN = ROOT / "tests" / "goldens" / "lm_whisper_small_smoke.npz"
VLM_B_LAYOUT = (64, (8, 16), 64)
VLM_C_LAYOUT = (2048, (64, 64), 2048)
AUDIO_C_B, AUDIO_C_S, AUDIO_C_CACHE, AUDIO_POS_LO = 16, 227, 448, 64

# The PointPillars detector (models/detector3d.py). Det A holds the card to
# the JAX golden at a small config; Det B runs the default config (128x128
# pillars, feat 32, backbone (32, 64, 128)) on kitti-urban frames.
DET_GOLDEN = ROOT / "tests" / "goldens" / "det3d_smoke.npz"
DET_FRAMES, DET_STEPS, DET_CPU_FRAMES = 24, 8, 2

KERNELS = {
    # K1's two instances: the full outputs, and the labels alone (the
    # serving path's project_and_label).
    "point_proj": ("src/repro_torch/csrc/point_proj.cu",
                   "src/repro/kernels/point_proj/point_proj.py:43"),
    "point_proj_labels": ("src/repro_torch/csrc/point_proj.cu",
                          "src/repro/kernels/point_proj/point_proj.py:43"),
    "iou2d": ("src/repro_torch/csrc/iou2d.cu",
              "src/repro/kernels/iou2d/iou2d.py:36"),
    "ransac_score": ("src/repro_torch/csrc/ransac_score.cu",
                     "src/repro/kernels/ransac_score/ransac_score.py:34"),
    # The 3xTF32 route (f32; bf16 at head dims 16 and 32).
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:78"),
    # The same TPU kernel's bf16 tensor-core route (head dims 64 and 128,
    # MLA's 192 / 128).
    "flash_attention_tc": (
        "src/repro_torch/csrc/flash_attention_tc.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:78"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:63"),
    # The two attention gradients: the VJPs around the Pallas calls
    # (repro/ops/api.py; plain JAX, recomputing the scores).
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/ops/api.py:54"),
    # K5's gradient on the tensor cores (bf16 at head dims 64 and 128, and
    # MLA's qk 192 / value 128).
    "flash_attention_bwd_tc": (
        "src/repro_torch/csrc/flash_attention_bwd_tc.cu",
        "src/repro/ops/api.py:54"),
    "decode_attention_bwd": ("src/repro_torch/csrc/decode_attention_bwd.cu",
                             "src/repro/ops/api.py:87"),
    # No Pallas counterpart: the einsums of MLA's absorbed decode.
    "mla_decode_attention": ("src/repro_torch/csrc/mla_decode_attention.cu",
                             "src/repro/models/mla.py:96"),
    "pillar_scatter": (
        "src/repro_torch/csrc/pillar_scatter.cu",
        "src/repro/kernels/pillar_scatter/pillar_scatter.py:50"),
    # The gradient: the VJP around the Pallas call (repro/ops/api.py).
    "pillar_scatter_bwd": ("src/repro_torch/csrc/pillar_scatter.cu",
                           "src/repro/ops/api.py:105"),
    # No Pallas counterpart: the association's lax.while_loop auction; its
    # wide instance takes n > 128.
    "auction": ("src/repro_torch/csrc/auction.cu",
                "src/repro/core/association.py:121"),
    "auction_wide": ("src/repro_torch/csrc/auction.cu",
                     "src/repro/core/association.py:121"),
}


# The instances at MLA's head dims (and the gradient's at moonshot's G = 1)
# that the kernel JSON line lists as entries of their own: (kernel,
# phase-3 case) -> (key of its timed record, label, the path whose
# launches are its own).
INSTANCES = {
    ("flash_attention_tc", 6): ("deepseek", "qk 192 / value 128, bf16",
                                "MLA C serving"),
    ("flash_attention_bwd_tc", 15): ("deepseek", "qk 192 / value 128, bf16 "
                                     "(persistent: a CTA an SM)",
                                     "MLA T training"),
    ("flash_attention_bwd_tc", 16): ("moonshot", "hd 128, G = 1, bf16",
                                     "MoE T training"),
    ("flash_attention_bwd", 15): ("deepseek_f32", "qk 192 / value 128, f32 "
                                  "(8-warp dq skipping dead tiles, 8-warp "
                                  "dkv)", "MLA T f32 correctness"),
    ("flash_attention_bwd", 16): ("deepseek_smoke", "qk 24 / value 16, f32",
                                  "MLA T SMOKE f32"),
    ("flash_attention_bwd", 17): ("deepseek_smoke_bf16",
                                  "qk 24 / value 16, bf16",
                                  "MLA T SMOKE bf16"),
    ("flash_attention", 7): ("deepseek_f32", "qk 192 / value 128, f32 "
                             "(persistent: 8 warps, 32-key tiles)", "MLA B"),
    ("flash_attention", 9): ("deepseek_smoke", "qk 24 / value 16, f32",
                             "MLA A"),
    ("flash_attention", 13): ("deepseek_smoke_bf16",
                              "qk 24 / value 16, bf16", "MLA A bf16"),
    ("mla_decode_attention", 3): ("tf32x3", "tf32x3, f32, (512, 64)",
                                  "MLA B"),
    ("mla_decode_attention", 4): ("simt_smoke", "SIMT, f32, (16, 8)",
                                  "MLA A"),
    # The vlm and audio families: qwen2-vl-2b's G = 6, whisper-small's hd
    # 64 (the flash_attention_tc and decode_attention entries hold the
    # timings of whisper's other shapes, whisper_self and whisper_cross;
    # Audio C's launches are those of all its shapes).
    ("flash_attention_tc", 20): ("qwen2_vl", "hd 128, G = 6, bf16",
                                 "VLM C serving"),
    ("flash_attention_tc", 21): ("whisper", "hd 64, G = 1, bf16, the "
                                 "encoder (1,500 frames, full); launches: "
                                 "the encoder's, the decoder's self and "
                                 "cross attention", "Audio C serving"),
    ("decode_attention", 11): ("qwen2_vl", "hd 128, G = 6, bf16",
                               "VLM C serving"),
    ("decode_attention", 12): ("whisper", "hd 64, G = 1, bf16, the G = 1 "
                               "layout (a block of 4 warps a unit of the "
                               "grid's split of S, each warp its own "
                               "cp.async ring and online softmax), the self "
                               "cache (448; the cross caches: the "
                               "decode_attention entry's whisper_cross); "
                               "launches: self and cross attention",
                               "Audio C serving"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def eager_ms(fn, torch, runs: int = 100, warmup: int = 10) -> float:
    """Median of ``runs`` CUDA-event timings of one eager call each: what a
    Python caller waits per call, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def graph_ms(fn, torch, reps: int = 50, replays: int = 20) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph, the
    median over ``replays`` event-timed replays divided by ``reps``. The
    inputs stay in the 50 MB L2 cache between calls (warm-cache time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def profile_window(torch, label: str, run, n: int, unit: str,
                   names=()) -> str:
    """A torch.profiler window over ``run()`` (``n`` ``unit``s of work):
    device busy share of the window, device ops per unit, the ops (and
    kernels) with the most device time, and the device time and launches
    per unit of the kernels whose names contain one of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    if not busy_us:
        return "profile: no device time in the trace (not measured)"
    launches = sum(e.count for e in dev)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:6]
    top = ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} ms "
                    f"x{e.count}" for e in ops)
    kern = sorted(dev, key=lambda e: e.self_device_time_total,
                  reverse=True)[:4]
    top_k = ", ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms"
                      f" x{e.count}" for e in kern)
    named = "".join(
        f"; {name} {t / 1e3 / n:.3f} ms x{sum(e.count for e in hit) / n:g} "
        f"a {unit} ({100 * t / busy_us:.1f}% of the device time)"
        for name in names
        for hit in [[e for e in dev if name in e.key]]
        for t in [sum(e.self_device_time_total for e in hit)])
    return (f"profile {label} x{n} {unit}s: wall "
            f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
            f"({100 * busy_us / wall_us:.1f}% of wall), "
            f"{launches / n:.0f} device ops/{unit}; top device time: "
            f"{top}; top kernels: {top_k}{named}")


def device_kernels(torch, fn, calls: int = 10):
    """Device time per call of each kernel (and memset) that ``fn()``
    launches, from a torch.profiler window over ``calls`` calls after a
    warm-up: [(name, ms a call, launches a call)], the longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    return sorted(((e.key, e.self_device_time_total / 1e3 / calls,
                    e.count / calls) for e in dev), key=lambda x: -x[1])


def kernels_line(label: str, kerns) -> str:
    if not kerns:
        return f"profile {label}: no device time in the trace (not measured)"
    return f"profile {label}: " + "; ".join(
        f"{name[:90]} {ms:.5f} ms x{n:g}" for name, ms, n in kerns)


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def on_card(torch, dev, pts, unaligned: bool):
    """(N, 3) numpy points on the card: contiguous, or a contiguous view
    one row into a larger tensor (``big[1:]``, a base 12 bytes past a
    16-byte boundary)."""
    if not unaligned:
        return torch.from_numpy(pts).to(dev)
    big = torch.zeros((len(pts) + 1, 3), dtype=torch.float32, device=dev)
    big[1:] = torch.from_numpy(pts).to(dev)
    return big[1:]


def proj_inputs(torch, np, dev, scenes, n, h, w, seed, unaligned=False):
    """K1's synthetic inputs on the card: n points spread over KITTI's
    field of view, KITTI's calibration, a random (h, w) label image."""
    rng = np.random.default_rng(seed)
    tr, p = scenes.make_calibration(scenes.SceneConfig(img_h=h, img_w=w))
    pts = np.concatenate([rng.uniform(-5, 70, (n, 1)),
                          rng.uniform(-25, 25, (n, 1)),
                          rng.uniform(-2, 2, (n, 1))], 1).astype(np.float32)
    lab = rng.integers(0, 13, (h, w)).astype(np.int32)
    return (on_card(torch, dev, pts, unaligned),
            *(torch.from_numpy(a).to(dev) for a in (tr, p, lab)))


def proj_shape(pts, lab, visible, what: str = "") -> str:
    n, (h, w) = pts.shape[0], lab.shape
    n_vis = int(visible.sum())
    base = f", base +{pts.data_ptr() % 16} B" if pts.data_ptr() % 16 else ""
    return (f"N={n} image={h}x{w}{what}{base}, {n_vis} visible "
            f"({n_vis / max(n, 1):.4f})")


def check_point_proj(torch, pp_ops, pp_ref, pts, tr, p, lab):
    """K1's full instance vs its plain version, every output bit for bit;
    returns the record. ``lab`` gives the image's shape (the labels are
    the other instance's)."""
    h, w = lab.shape
    got = pp_ops.point_proj(pts, tr, p, h, w)
    want = pp_ref.point_proj_ref(pts, tr, p, h, w)[:4]
    shape = proj_shape(pts, lab, want[2])
    for name, g, r in zip(("uv", "depth", "visible", "flat"), got, want):
        if not torch.equal(g, r):
            fail(f"point_proj {shape}: {name} differs from the plain version"
                 + (f" (max abs err {float((g - r).abs().max())})"
                    if g.dtype == torch.float32 else ""))
    n = pts.shape[0]
    # Bytes: xyz + calibration in, uv + depth + visible + flat out. Ops:
    # two 3x4 affine maps, the divide, bounds and index arithmetic (~60
    # f32 ops a point).
    rec = dict(shape=shape, exact=True, max_abs_err=0.0, tol="bit for bit",
               bytes=n * 12 + 96 + n * 17, ops=60 * n)
    return rec, (lambda: pp_ops.point_proj(pts, tr, p, h, w)), \
        (lambda: pp_ref.point_proj_ref(pts, tr, p, h, w))


def check_point_proj_labels(torch, pp_ops, pp_ref, pts, tr, p, lab,
                            what: str = ""):
    """K1's labels instance vs the plain version's labels, bit for bit;
    returns the record. Its bound counts what it moves: xyz and the
    calibration in, the visible points' gathers, the labels out."""
    h, w = lab.shape
    got = pp_ops.project_and_label(pts, tr, p, lab)
    want = pp_ref.point_proj_ref(pts, tr, p, h, w, lab)
    shape = proj_shape(pts, lab, want[2], what)
    if not torch.equal(got, want[4]):
        fail(f"point_proj_labels {shape}: labels differ from the plain "
             f"version")
    n, n_vis = pts.shape[0], int(want[2].sum())
    rec = dict(shape=shape, exact=True, max_abs_err=0.0, tol="bit for bit",
               bytes=n * 12 + 96 + n_vis * 4 + n * 4, ops=60 * n)
    return rec, (lambda: pp_ops.project_and_label(pts, tr, p, lab)), \
        (lambda: pp_ref.point_proj_ref(pts, tr, p, h, w, lab)[4])


def proj_fleet_inputs(torch, np, dev, scenes, s, n, h, w, seed):
    """K1's labels instance with a stream axis: S streams of ``proj_inputs``
    stacked, (S, N, 3) points and (S, H, W) images, one calibration."""
    ins = [proj_inputs(torch, np, dev, scenes, n, h, w, seed + i)
           for i in range(s)]
    return (torch.stack([x[0] for x in ins]), ins[0][1], ins[0][2],
            torch.stack([x[3] for x in ins]))


def check_labels_fleet(torch, pp_ops, pp_ref, pts, tr, p, lab,
                       what: str = ""):
    """The labels instance over a stream axis: bit for bit against the
    plain version and, stream by stream, against the 2-D kernel (those
    launches compare, they are no main path's)."""
    s_n, n = pts.shape[:2]
    h, w = lab.shape[1:]
    got = pp_ops.project_and_label(pts, tr, p, lab)
    want = pp_ref.point_proj_ref(pts, tr, p, h, w, lab)
    n_vis = int(want[2].sum())
    shape = (f"S={s_n} N={n} image={h}x{w}{what}, {n_vis} visible "
             f"({n_vis / max(s_n * n, 1):.4f})")
    if not torch.equal(got, want[4]):
        fail(f"point_proj_labels {shape}: labels differ from the plain "
             f"version")
    for i in range(s_n):
        if not torch.equal(got[i], pp_ops.project_and_label(pts[i], tr, p,
                                                            lab[i])):
            fail(f"point_proj_labels {shape}: stream {i} differs from the "
                 f"2-D kernel")
    rec = dict(shape=shape, exact=True, max_abs_err=0.0,
               tol="bit for bit, and the 2-D kernel stream by stream",
               bytes=s_n * n * 12 + 96 + n_vis * 4 + s_n * n * 4,
               ops=60 * s_n * n)
    return rec, (lambda: pp_ops.project_and_label(pts, tr, p, lab)), \
        (lambda: pp_ref.point_proj_ref(pts, tr, p, h, w, lab)[4])


def check_iou2d(torch, np, dev, iou_ops, iou_ref, n, m, seed, s=None):
    """K2 against its plain version, bit for bit; with ``s``, over a stream
    axis (S, N, 4) x (S, M, 4), also against the 2-D kernel stream by
    stream."""
    rng = np.random.default_rng(seed)
    lead = () if s is None else (s,)

    def boxes(cnt):
        xy = rng.uniform(0, 1242, (*lead, cnt, 2))
        wh = rng.uniform(1, 200, (*lead, cnt, 2))
        return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                                .astype(np.float32)).to(dev)
    a, b = boxes(n), boxes(m)
    got, want = iou_ops.iou2d(a, b), iou_ref.iou2d_ref(a, b)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    shape = f"{n}x{m}" if s is None else f"S={s} {n}x{m}"
    if not torch.equal(got, want):
        fail(f"iou2d {shape}: not bit-equal to the plain version (off by "
             f"{err})")
    for i in range(s or 0):
        if not torch.equal(got[i], iou_ops.iou2d(a[i], b[i])):
            fail(f"iou2d {shape}: stream {i} differs from the 2-D kernel")
    k = s or 1
    rec = dict(shape=shape, exact=True, max_abs_err=err,
               tol="bit for bit" + ("" if s is None else
                                    ", and the 2-D kernel stream by stream"),
               bytes=k * ((n + m) * 16 + n * m * 4), ops=17 * k * n * m)
    return rec, (lambda: iou_ops.iou2d(a, b)), \
        (lambda: iou_ref.iou2d_ref(a, b))


def check_ransac(torch, np, dev, rs_ops, rs_ref, o, k, p, seed, dead=None):
    """Kernel vs plain version, counts exact; object ``dead`` (if given)
    has every point masked out."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.normal(0, 5, (o, p, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(o, p)) < 0.8)
    if dead is not None:
        valid[dead] = False
    nrm = rng.normal(size=(o, k, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = torch.from_numpy(nrm.astype(np.float32))
    off = torch.from_numpy(rng.normal(0, 3, (o, k)).astype(np.float32))
    args = [t.to(dev) for t in (pts, valid, nrm, off)]
    got = rs_ops.ransac_score(*args, 0.5)
    want = rs_ref.ransac_score_ref(*args, 0.5)
    if not torch.equal(got, want):
        fail(f"ransac_score (O,K,P)=({o},{k},{p}): counts differ")
    shape = f"O={o} K={k} P={p}" + (
        f", object {dead} all invalid" if dead is not None else "")
    rec = dict(shape=shape, exact=True, max_abs_err=0.0,
               bytes=o * p * 13 + o * k * 16 + o * k * 4, ops=8 * o * k * p)
    return rec, (lambda: rs_ops.ransac_score(*args, 0.5)), \
        (lambda: rs_ref.ransac_score_ref(*args, 0.5))


# The auction's phase-3 cases: persons a matrix (each side of one warp's 32,
# two warps' 64, the row instances' cap last) and auctions a launch; the
# plain version is timed too at n = 40 and 128, one auction.
AUCTION_NS = (1, 2, 12, 16, 24, 31, 32, 33, 40, 64, 128)
AUCTION_BATCHES = (1, 16, 64, 256)
AUCTION_PLAIN_TIMED = ((40, 1), (128, 1))
# The wide instance's seeded cases (n > 128). Their ties take more rounds a
# phase than the serving default of 4,000 from n = 512 (at n = 1024 one
# phase needs more), so both versions run them with this cap.
AUCTION_WIDE_NS = (129, 160, 256, 512, 1024)
AUCTION_WIDE_BATCHES = (1, 16)
WIDE_MAX_ITER = 20000


def auction_benefits(np, n, batch, seed, zero_rows=False, equal_rows=False):
    """Seeded (batch, n, n) benefits on the association's 1e-3 grid, drawn
    from 20 levels so that many tie exactly; with ``zero_rows`` about a
    third of the rows and of the columns are 0 (the invalid pairs and the
    padding of a non-square association); with ``equal_rows`` every row is
    the first (all persons bid on one object each round)."""
    rng = np.random.default_rng(seed)
    b = (rng.integers(0, 20, (batch, n, n)) * np.float32(1e-3)) \
        .astype(np.float32)
    if zero_rows:
        b[:, rng.uniform(size=n) < 1 / 3, :] = 0.0
        b[:, :, rng.uniform(size=n) < 1 / 3] = 0.0
    if equal_rows:
        b[:] = b[:, :1]
    return b


def record_auctions(torch, au_ops, run):
    """The benefit matrices that ``run()`` hands the auction, in call
    order (copies on the card)."""
    real, seen = au_ops.auction, []

    def recording(benefit, *args, **kw):
        seen.append(benefit.clone())
        return real(benefit, *args, **kw)
    au_ops.auction = recording
    try:
        run()
    finally:
        au_ops.auction = real
    torch.cuda.synchronize()
    return seen


def optimum_cols(np, hungarian, b):
    """A maximum-benefit assignment of the square matrix ``b``:
    ``hungarian_numpy`` (pure Python, O(n^3)) up to 128 persons, SciPy's
    ``linear_sum_assignment`` above; at n = 129 both, their optima held
    equal."""
    n = b.shape[0]
    if n <= 128:
        return hungarian(-b)
    from scipy.optimize import linear_sum_assignment
    cols = linear_sum_assignment(-b)[1]
    if n == 129:
        ar = np.arange(n)
        h = hungarian(-b)
        if abs(b[ar, h].sum() - b[ar, cols].sum()) > 1e-9:
            fail(f"auction: hungarian_numpy's and SciPy's optima differ at "
                 f"n = {n}")
    return cols


def bidders_a_round(torch, benefit, max_iter: int):
    """The unassigned persons of each auction in each round of the plain
    version's rounds (``auction/ref.py``'s arithmetic, replayed) on (...,
    n, n) benefits: a (rounds, B) int64 tensor, every phase's rounds to the
    last that any auction runs (an auction whose phase has ended counts 0
    there, and changes nothing, as the plain version's mask holds it)."""
    from repro_torch.core.batching import take
    from repro_torch.kernels.auction.ref import phase_epsilons
    n = benefit.shape[-1]
    b = benefit.reshape(-1, n, n)
    dev = b.device
    prices = torch.zeros(b.shape[:2], dtype=b.dtype, device=dev)
    ar = torch.arange(n, device=dev)
    neg_col = torch.full((*b.shape[:2], 1), -1e9, dtype=b.dtype, device=dev)
    neg_mat = torch.full_like(b, -1e9)
    out = []
    for eps in phase_epsilons(1e-4):
        p2o = torch.full(b.shape[:2], -1, dtype=torch.int64, device=dev)
        for _ in range(max_iter):
            unassigned = p2o < 0
            left = unassigned.sum(-1)
            if not bool(left.any()):
                break
            out.append(left)
            values = b - prices[:, None, :]
            top2 = torch.topk(torch.cat([values, neg_col], -1), 2,
                              -1).values
            best_j = values.argmax(-1)
            bid = take(prices, best_j) + top2[..., 0] - top2[..., 1] + eps
            bid_mat = neg_mat.scatter(-1, best_j[..., None], torch.where(
                unassigned, bid, -1e9)[..., None])
            best_bid, winner = bid_mat.amax(-2), bid_mat.argmax(-2)
            has_bid = best_bid > -5e8
            won = unassigned & take(has_bid, best_j) \
                & (take(winner, best_j) == ar)
            cur = p2o.clamp(0, n - 1)
            evicted = (p2o >= 0) & take(has_bid, cur) \
                & (take(winner, cur) != ar)
            p2o = torch.where(won, best_j, torch.where(evicted, -1, p2o))
            prices = torch.where(has_bid, best_bid, prices)
    if not out:
        return torch.zeros((0, len(b)), dtype=torch.int64, device=dev)
    return torch.stack(out)


def check_auction(torch, np, au_ops, au_ref, hungarian, benefit, what,
                  max_iter: int = 4000, skeleton: bool = True,
                  count_bidders: bool = False):
    """The auction kernel against its plain version on the card, bit for bit
    in person_to_obj, the prices and the rounds; the assignment a
    permutation whose total benefit is within n x eps_final (1e-4) of the
    optimum (``optimum_cols``) on the first matrices (up to 4; 1 at
    n > 40). ``max_iter``: rounds a phase, both versions. The operations
    are 6 a column of each bidder's row, the bidders counted by
    ``bidders_a_round`` where ``count_bidders`` (a record measured in
    full), else every person every round."""
    lead, n = tuple(benefit.shape[:-2]), benefit.shape[-1]
    got = au_ops.auction(benefit, max_iter_per_phase=max_iter)
    want = au_ref.auction_ref(benefit, max_iter_per_phase=max_iter)
    shape = f"B={math.prod(lead)} n={n}{what}" + (
        f", {max_iter} rounds a phase" if max_iter != 4000 else "")
    for name, g, w in zip(("person_to_obj", "prices", "rounds"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(
                g.view(torch.int32) if g.dtype == torch.float32 else g,
                w.view(torch.int32) if w.dtype == torch.float32 else w):
            fail(f"auction {shape}: {name} differs from the plain version")
    b = benefit.reshape(-1, n, n).cpu().double().numpy()
    p2o = got[0].reshape(-1, n).cpu().numpy()
    ar = np.arange(n)
    worst = 0.0
    for i in range(len(b)):
        if sorted(p2o[i]) != list(ar):
            fail(f"auction {shape}: matrix {i} is not assigned a permutation")
        if i < (4 if n <= 40 else 1):
            opt = b[i][ar, optimum_cols(np, hungarian, b[i])].sum()
            gap = opt - b[i][ar, p2o[i]].sum()
            worst = max(worst, gap)
            if gap > n * 1e-4 + 1e-6:
                fail(f"auction {shape}: matrix {i}'s total benefit is "
                     f"{gap} under the optimum (limit n x 1e-4)")
    rounds = got[2].reshape(-1).cpu()
    bids = n * int(rounds.sum())
    if count_bidders:
        left = bidders_a_round(torch, benefit, max_iter).cpu()
        if not torch.equal((left > 0).sum(0).to(torch.int32), rounds):
            fail(f"auction {shape}: the replayed rounds "
                 f"{(left > 0).sum(0).tolist()} are not the kernel's")
        bids = int(left.sum())
    rec = dict(shape=shape, exact=True, max_abs_err=0.0,
               tol="bit for bit (person_to_obj, prices, rounds); total "
                   "benefit within n x 1e-4 of the optimum",
               optimality_gap=worst, rounds_max=int(rounds.max()),
               rounds_sum=int(rounds.sum()),
               bytes=len(b) * (n * n * 4 + n * 12 + 4),
               bidders=bids, ops=6 * n * bids, plain_eager=True)
    # The probe of a round's synchronisation and end test alone: the
    # one-warp instance's, or past 128 persons the wide instance's CTA
    # round.
    probe = au_ops.auction_skeleton_wide if n > 128 \
        else au_ops.auction_skeleton
    if skeleton:
        rec["skeleton"] = lambda: probe(got[2])
    return rec, (lambda: au_ops.auction(benefit,
                                        max_iter_per_phase=max_iter)), \
        (lambda: au_ref.auction_ref(benefit, max_iter_per_phase=max_iter))


def time_auction(torch, rec, kern, plain=None) -> None:
    """Device ms of an auction case that is not measured in full, its time
    a round (over its longest auction's rounds), its skeleton's ms where
    the record has one and, given ``plain``, its plain version's ms
    (eagerly: it synchronises)."""
    est = eager_ms(kern, torch, runs=3, warmup=1)
    reps = max(1, min(20, int(40 / est)))
    rec["kernel_ms"] = graph_ms(kern, torch, reps=reps, replays=5)
    rec["us_per_round"] = rec["kernel_ms"] * 1e3 / rec["rounds_max"]
    rec["skeleton_ms"] = graph_ms(rec.pop("skeleton"), torch, reps=reps,
                                  replays=5) if "skeleton" in rec else None
    rec["plain_ms"] = None if plain is None else eager_ms(
        plain, torch, runs=3, warmup=1)
    print(f"  device {rec['kernel_ms']:.5f} ms, {rec['us_per_round']:.4f} us"
          f" a round ({rec['rounds_max']} rounds)"
          + ("" if rec["skeleton_ms"] is None else
             f"; skeleton {rec['skeleton_ms']:.5f} ms")
          + ("" if plain is None else f"; plain {rec['plain_ms']:.4f} ms"),
          flush=True)


def bf16_limit(torch, want):
    """Per-value tolerance of a bf16 attention output held against the f32
    result of the plain version on the same bf16 inputs: half a bf16 ulp of
    the value (the output's own rounding; bf16 keeps 8 significant bits)
    plus 2e-5 of it and 1e-6 for the f32 sums taken in another order. A
    kernel that loses one 512-position chunk of a 20k-position request, or
    one 64-key tile of a row, is off by some 1e-3 and fails."""
    _, e = torch.frexp(want)
    half_ulp = torch.where(want == 0, 0.0,
                           torch.ldexp(torch.ones_like(want), e - 9))
    return half_ulp + 2e-5 * want.abs() + 1e-6


# The tensor-core flash attention rounds p to bf16 (round to nearest, a
# relative error of at most 2^-8) before its P.V product, as every
# tensor-core flash attention does. Its check adds P_ROUNDING times the
# root-sum-square of those errors, sqrt(sum_j a_ij^2 v_jd^2) with
# a = p / l the softmax weights (``p_rounding_term``).
P_ROUNDING = 4 * 2.0 ** -8


def p_rounding_term(torch, q, k, v, causal: bool):
    """sqrt(sum_j a_ij^2 v_jd^2) in f32 for attention inputs q (B, H, SQ,
    hd), k/v (B, KV, SK, hd), a = the plain version's softmax weights with
    its masking; one head at a time, so a prefill-size call holds one
    (SQ, SK) score matrix."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    live = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        live = live.tril()
    for head in range(h):
        kh = head // (h // kv)
        s = q[:, head].float() @ k[:, kh].float().transpose(-1, -2) \
            * hd ** -0.5
        s = torch.where(live, s, -1e30)
        p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        a = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        del s, p
        out[:, head] = torch.sqrt((a * a) @ v[:, kh].float().square())
    return out


def attention_close(torch, got, plain, f32_args, args, what: str,
                    p_rounding=None):
    """Hold an attention kernel's output against its plain version: in f32
    within 2e-5 (absolute and relative); in bf16 against the plain
    version's f32 result on the same inputs (``f32_args``), within
    ``bf16_limit``, plus ``P_ROUNDING * p_rounding`` where the kernel
    rounds p to bf16 (``p_rounding``: ``p_rounding_term`` of the inputs).
    Returns (max abs err, tolerance, exact, worst), where exact says the
    output equals the plain result rounded to its type and worst is the
    largest difference over its limit."""
    if got.dtype == torch.float32:
        want = plain(*args)
        diff = (got - want).abs()
        err = float(diff.max()) if got.numel() else 0.0
        worst = float((diff / (2e-5 + 2e-5 * want.abs())).max()) \
            if got.numel() else 0.0
        if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
            fail(f"{what}: off by {err}, {worst:.3g} times the tolerance "
                 f"(2e-5 abs + 2e-5 rel)")
        return err, f"2e-5 abs + 2e-5 rel (worst {worst:.3g} of it)", \
            bool(torch.equal(got, want)), worst
    want = plain(*f32_args)
    diff = (got.float() - want).abs()
    limit = bf16_limit(torch, want)
    tol = "half a bf16 ulp + 2e-5 rel + 1e-6"
    if p_rounding is not None:
        limit = limit + P_ROUNDING * p_rounding
        tol += " + 2^-6 sqrt(sum a^2 v^2) (p rounded to bf16)"
    worst = float((diff / limit).max()) if got.numel() else 0.0
    err = float(diff.max()) if got.numel() else 0.0
    if worst > 1:
        fail(f"{what}: off by {err}, {worst:.3g} times the tolerance "
             f"({tol})")
    return err, f"{tol} (worst {worst:.3g} of it)", \
        bool(torch.equal(got, want.to(got.dtype))), worst


def heads_at_a_time(torch, plain, n: int):
    """``plain`` (an attention reference over (B, H, S, dim) operands with
    KV = H heads) computed ``n`` heads at a time: MLA's 128 heads at S 8192
    would hold 34 GB of scores at once."""
    def run(q, k, v, causal):
        return torch.cat([plain(q[:, i:i + n], k[:, i:i + n], v[:, i:i + n],
                                causal)
                          for i in range(0, q.shape[1], n)], dim=1)
    return run


def check_flash(torch, dev, fa_ops, fa_ref, b, h, kv, sq, sk, hd, dtype,
                causal, seed, vd=None):
    """Kernel vs plain version on (B, S, heads, hd) activations passed as
    (B, heads, S, hd) views, as the model passes them; v's head dim is
    ``vd`` (``hd`` when None: MLA's differ). The wrapper's route
    (``fa_ops.route``) picks the kernel; the tensor-core route's check
    allows for its p rounded to bf16 (``attention_close``). With KV = H
    past 16 heads the plain version runs 8 heads at a time."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vd = hd if vd is None else vd

    def act(heads, s, dim=hd):
        return torch.randn(b, s, heads, dim, generator=g, device=dev,
                           dtype=dtype).transpose(1, 2)
    q, k, v = act(h, sq), act(kv, sk), act(kv, sk, vd)
    route = fa_ops.route(dtype, hd, vd)
    counter = "tc_launches" if route == "tc" else "launches"
    before = getattr(fa_ops, counter)
    got = fa_ops.flash_attention(q, k, v, causal)
    if getattr(fa_ops, counter) != before + 1:
        fail(f"flash_attention: the {route} route's kernel did not launch")
    dims = f"{hd}" if vd == hd else f"{hd}/{vd}"
    shape = f"({b},{h},{kv},{sq},{sk},{dims}) {str(dtype)[6:]} " + \
        ("causal" if causal else "full")
    plain = fa_ref.flash_attention_ref
    if kv == h and h > 16:
        plain = heads_at_a_time(torch, plain, 8)
    p_rounding = p_rounding_term(torch, q, k, v, causal) \
        if route == "tc" else None
    err, tol, exact, worst = attention_close(
        torch, got, plain,
        (q.float(), k.float(), v.float(), causal), (q, k, v, causal),
        f"flash_attention ({route}) {shape}", p_rounding)
    del p_rounding
    # Live (query, key) pairs: query i sees keys [0, i] when causal.
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    elt = q.element_size()
    ops = 2 * (hd + vd) * b * h * pairs
    # The bf16 route's products are single bf16 products; the 3xTF32
    # route's are three TF32 products each in f32 (Q.K^T one and P.V two
    # for bf16 inputs, which TF32 holds exactly).
    tf32_terms = 3 if dtype == torch.float32 else 1.5
    rec = dict(shape=shape, exact=exact, max_abs_err=err, tol=tol,
               worst=worst,
               bytes=(b * h * sq * (hd + vd) + b * kv * sk * (hd + vd))
               * elt,
               ops=ops if route == "tc" else tf32_terms * ops,
               peak=PEAK_BF16_PER_S if route == "tc" else PEAK_TF32_PER_S,
               f32_simt_ms=ops / PEAK_F32_PER_S * 1e3,
               library=lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, enable_gqa=True))
    if route == "tc":
        # One exp2 a live (query head, key) pair on the special-function
        # units: at hd 64 as long as the products (not part of the bound).
        rec["exp2_floor_ms"] = b * h * pairs / EXP2_PER_S * 1e3
    return rec, (lambda: fa_ops.flash_attention(q, k, v, causal)), \
        (lambda: plain(q, k, v, causal))


def check_decode(torch, dev, dec_ops, dec_ref, b, h, kv, s, hd, dtype,
                 pos, seed):
    """Kernel vs plain version on (B, S, KV, hd) caches passed as
    (B, KV, S, hd) views; ``pos`` is a list, or (lo, hi) for ragged
    positions drawn in [lo, hi)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=g, device=dev, dtype=dtype)[:, 0]
    ck, cv = (torch.randn(b, s, kv, hd, generator=g, device=dev,
                          dtype=dtype).transpose(1, 2) for _ in range(2))
    if isinstance(pos, tuple):
        pos = torch.randint(*pos, (b,), generator=g, device=dev,
                            dtype=torch.int32)
    else:
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    kind = dec_ops.layout(dtype, hd, h // kv)
    before = dec_ops.layout_launches[kind]
    got = dec_ops.decode_attention(q, ck, cv, pos)
    if dec_ops.layout_launches[kind] != before + 1:
        fail(f"decode_attention: the {kind} layout did not launch")
    if kind == "g1":
        span, units = dec_ops.g1_plan(s, b * h, hd,
                                      dec_ops._sm_count(dev.index))
        kind = f"g1: {span} positions a unit, {units} a row"
    shape = (f"B={b} H={h} KV={kv} S={s} hd={hd} {str(dtype)[6:]} "
             f"pos {int(pos.min())}..{int(pos.max())}, layout {kind}")
    err, tol, exact, worst = attention_close(
        torch, got, dec_ref.decode_attention_ref,
        (q.float(), ck.float(), cv.float(), pos), (q, ck, cv, pos),
        f"decode_attention {shape}")
    live = int(pos.clamp(max=s).sum())
    elt = q.element_size()
    mask = (torch.arange(s, device=dev)[None, :] < pos[:, None])[:, None,
                                                                  None]
    rec = dict(shape=shape, exact=exact, max_abs_err=err, tol=tol,
               worst=worst,
               bytes=(2 * b * h * hd + 2 * kv * hd * live) * elt + 4 * b,
               ops=4 * hd * (h // kv) * kv * live,
               peak=PEAK_BF16_PER_S if dtype == torch.bfloat16
               else PEAK_F32_PER_S,
               library=lambda: torch.nn.functional.scaled_dot_product_attention(
                   q[:, :, None], ck, cv, attn_mask=mask, enable_gqa=True))
    return rec, (lambda: dec_ops.decode_attention(q, ck, cv, pos)), \
        (lambda: dec_ref.decode_attention_ref(q, ck, cv, pos))


def mla_p_rounding_term(torch, q_lat, q_rope, ckv, krope, lengths, scale):
    """sqrt(sum_j a_hj^2 ckv_jr^2) in f32 for the MLA decode kernel's
    inputs, a = the plain version's softmax weights over positions
    [0, lengths): its allowance for p rounded to bf16."""
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(), krope.float())) \
        * scale
    live = (torch.arange(ckv.shape[1], device=s.device)[None, :]
            < lengths[:, None])[:, None]
    s = torch.where(live, s, -1e30)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    a = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    del s, p
    return torch.sqrt(torch.einsum("bhs,bsr->bhr", a * a,
                                   ckv.float().square()))


def check_mla_decode(torch, dev, mla_ops, mla_ref, b, h, s, r, p, dtype,
                     lengths, seed):
    """The MLA decode kernel vs its plain version: q_lat (B, H, R), q_rope
    (B, H, P), caches ckv (B, S, R), krope (B, S, P); ``lengths`` a list,
    or (lo, hi) for ragged lengths drawn in [lo, hi). The scale is
    deepseek-v2's (nope + rope)^-0.5 = 192^-0.5 at R 512, SMOKE's 24^-0.5
    at R 16. bf16 within half an ulp of the plain f32 result plus
    P_ROUNDING x ``mla_p_rounding_term`` (the tensor-core instance rounds
    p to bf16 for its P.V product, and the op's semantics, JAX's, round
    the weights to bf16: the SIMT instance, which keeps them f32, is held
    to the same allowance); f32 within 2e-5. The library
    yardstick is SDPA on the same values laid out as one query head of
    H queries: q = [q_lat | q_rope] (B, 1, H, R + P), K = [ckv | krope]
    (B, 1, S, R + P), V = ckv, a length mask and the same scale (the K
    copy made before the timed call). SDPA with enable_gqa (B, H, 1, .)
    over one kv head computes the same, but its math backend would copy
    K and V to every head (77 GB at B 16, S 32k)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    q_lat, q_rope, ckv, krope = rnd(b, h, r), rnd(b, h, p), rnd(b, s, r), \
        rnd(b, s, p)
    if isinstance(lengths, tuple):
        lengths = torch.randint(*lengths, (b,), generator=g, device=dev,
                                dtype=torch.int32)
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = (128 + 64) ** -0.5 if r == 512 else (16 + 8) ** -0.5
    path = mla_ops.route(dtype, r, p)
    before = mla_ops.launches
    got = mla_ops.mla_decode_attention(q_lat, q_rope, ckv, krope, lengths,
                                       scale)
    if mla_ops.launches != before + 1:
        fail("mla_decode_attention: the kernel did not launch")
    shape = (f"B={b} H={h} S={s} R={r} P={p} {str(dtype)[6:]} ({path}) "
             f"lengths {int(lengths.min())}..{int(lengths.max())}")
    args = (q_lat, q_rope, ckv, krope, lengths, scale)
    p_rounding = mla_p_rounding_term(torch, *args) \
        if dtype == torch.bfloat16 else None
    err, tol, exact, worst = attention_close(
        torch, got, mla_ref.mla_decode_attention_ref,
        tuple(t.float() for t in args[:4]) + args[4:], args,
        f"mla_decode_attention {shape}", p_rounding)
    del p_rounding
    live = int(lengths.clamp(0, s).sum())
    elt = q_lat.element_size()
    qf = torch.cat([q_lat, q_rope], -1)[:, None]
    kf = torch.cat([ckv, krope], -1)[:, None]
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[
        :, None, None]
    # The tf32x3 instance takes three TF32 products a product.
    ops = 2 * h * live * (2 * r + p)
    rec = dict(shape=shape, exact=exact, max_abs_err=err, tol=tol,
               worst=worst,
               bytes=(b * h * (2 * r + p) + live * (r + p)) * elt + 4 * b,
               ops=3 * ops if path == "tf32x3" else ops,
               peak={"tc": PEAK_BF16_PER_S, "tf32x3": PEAK_TF32_PER_S}.get(
                   path, PEAK_F32_PER_S),
               library=lambda: torch.nn.functional.scaled_dot_product_attention(
                   qf, kf, ckv[:, None], attn_mask=mask, scale=scale))
    if path == "tf32x3":
        rec["f32_simt_ms"] = ops / PEAK_F32_PER_S * 1e3
    return rec, (lambda: mla_ops.mla_decode_attention(*args)), \
        (lambda: mla_ref.mla_decode_attention_ref(*args))


def bwd_rounding_terms(torch, q, k, v, o, do, causal: bool):
    """The rounding terms of the tensor-core gradient's allowance, in
    float64, for q (B, H, SQ, hd), o, do (B, H, SQ, vd), k (B, KV, SK, hd)
    and v (B, KV, SK, vd): with a
    the plain version's softmax weights and ds its dS (float64, its
    masking), dQ[i,d]: scale sqrt(sum_j (ds_ij k_jd)^2), dK[j,d]: scale
    sqrt(sum_i (ds_ij q_id)^2), dV[j,d]: sqrt(sum_i (a_ij do_id)^2), the
    sums of dK and dV running over the G query heads of a kv head too.
    One query head at a time, so LM T's S = 4096 holds one (SQ, SK)
    matrix of each. Returns (dq, dk, dv) terms."""
    b, h, sq, hd = q.shape
    kv, sk, vd = k.shape[1], k.shape[2], v.shape[-1]
    f64 = torch.float64
    scale = hd ** -0.5
    tq = torch.zeros((b, h, sq, hd), dtype=f64, device=q.device)
    tk = torch.zeros((b, kv, sk, hd), dtype=f64, device=q.device)
    tv = torch.zeros((b, kv, sk, vd), dtype=f64, device=q.device)
    live = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        live = live.tril()
    for head in range(h):
        kh = head // (h // kv)
        qh, kh_, vh = q[:, head].to(f64), k[:, kh].to(f64), v[:, kh].to(f64)
        oh, doh = o[:, head].to(f64), do[:, head].to(f64)
        s = torch.where(live, qh @ kh_.transpose(-1, -2) * scale, -1e30)
        p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        a = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        del s, p
        ds = a * (doh @ vh.transpose(-1, -2)
                  - (doh * oh).sum(-1, keepdim=True))
        tv[:, kh] += (a * a).transpose(-1, -2) @ (doh * doh)
        del a
        ds = ds * ds
        tq[:, head] = ds @ (kh_ * kh_)
        tk[:, kh] += ds.transpose(-1, -2) @ (qh * qh)
        del ds
    return scale * tq.sqrt(), scale * tk.sqrt(), tv.sqrt()


def grads_close(torch, got, want, what: str, p_rounding=None):
    """Hold a backward kernel's (dq, dk, dv) against its plain version's:
    in f32 each within 2e-5 of the gradient's scale (the largest magnitude
    of the three) on the same inputs (flash attention's computed in
    float64; with one key, dq and dk are exactly 0 and the kernel gives
    the rounding of dP - D, terms of dV's size); in bf16 each value within
    ``bf16_limit`` of the plain version's result on the same bf16 inputs
    computed in float64 (the exact gradient, since the plain version's own
    f32 result strays from it by up to 0.6 of that limit at S = 2048, long
    sums of cancelling terms). The 3xTF32 kernel's products keep f32
    accuracy and it rounds each output once, so that is all; the bf16
    tensor-core kernel rounds P and dS to bf16 as operands of its
    products, so its check adds ``P_ROUNDING`` times each value's
    rounding term (``p_rounding``: ``bwd_rounding_terms`` of the inputs,
    the root-sum-square of those roundings' contributions). Returns (max
    abs err, tolerance text, worst difference over its limit)."""
    err = worst = 0.0
    scale = max((float(w.abs().max()) for w in want if w.numel()),
                default=0.0)
    terms = p_rounding if p_rounding is not None else (None,) * 3
    for name, g, w, term in zip(("dq", "dk", "dv"), got, want, terms):
        if tuple(g.shape) != tuple(w.shape):
            fail(f"{what}: {name} has shape {tuple(g.shape)}, want "
                 f"{tuple(w.shape)}")
        diff = (g.double() - w.double()).abs()
        if g.dtype == torch.float32:
            limit = torch.full_like(diff, max(2e-5 * scale, 1e-30))
        else:
            limit = bf16_limit(torch, w.double())
            if term is not None:
                limit = limit + P_ROUNDING * term.to(limit.device)
        if g.numel():
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff / limit).max()))
        if not bool(torch.isfinite(g).all()) or worst > 1:
            at = int((diff / limit).argmax())   # g is not empty here
            where = [int(x) for x in torch.unravel_index(
                torch.tensor(at), tuple(g.shape))]
            fail(f"{what}: {name} off by {float(diff.max())}, {worst:.3g} "
                 f"times the tolerance (or not finite); the worst at "
                 f"{where}: {float(g.flatten()[at])} for "
                 f"{float(w.flatten()[at])}, limit "
                 f"{float(limit.flatten()[at])}")
    tol = ("2e-5 of the gradient's scale" if got[0].dtype == torch.float32
           else "half a bf16 ulp + 2e-5 rel + 1e-6 of the float64 result")
    if p_rounding is not None:
        tol += " + 2^-6 x its rounding term (P and dS rounded to bf16)"
    return err, f"{tol} (worst {worst:.3g} of it)", worst


def group_sum_path(torch, fa_ops, q, k, v, o, do, causal, got, what):
    """At G = 1 the gradient (either route) writes dK and dV directly;
    hold that to its partials and group-sum pass bit for bit. The same inputs
    at G = 2: query head 2i is head i (q, o, do), head 2i + 1 has do = 0,
    so its partials are zeros (dS = P (0 - 0)) and each kv head's sum is
    +0 + (head 2i's partial) + (a zero), which the direct write's +0
    reproduces; dq of the even heads is head i's, computed alike."""
    twice = [torch.repeat_interleave(t, 2, dim=1) for t in (q, o, do)]
    twice[2][:, 1::2] = 0
    grads = fa_ops.flash_attention_bwd(twice[0], k, v, twice[1], twice[2],
                                       causal)
    if not (torch.equal(grads[0][:, 0::2], got[0])
            and torch.equal(grads[1], got[1])
            and torch.equal(grads[2], got[2])):
        fail(f"{what}: the direct write of dK and dV at G = 1 differs from "
             f"the partials' group sum")


def bwd_heads_at_a_time(torch, plain, n: int):
    """``plain`` (a gradient reference over (B, H, S, dim) operands with KV
    = H heads) computed ``n`` heads at a time: MLA T's 128 heads at S 4096
    would hold 17 GB of float64 scores a tensor at once."""
    def run(q, k, v, o, do, causal):
        parts = [plain(q[:, i:i + n], k[:, i:i + n], v[:, i:i + n],
                       o[:, i:i + n], do[:, i:i + n], causal)
                 for i in range(0, q.shape[1], n)]
        return tuple(torch.cat(x, dim=1) for x in zip(*parts))
    return run


def check_flash_bwd(torch, dev, fa_ops, fa_ref, b, h, kv, sq, sk, hd, dtype,
                    causal, seed, views=True, vd=None):
    """K5's backward kernel vs its plain version, on the forward kernel's
    output and a random cotangent: q, k, v, o and do are (B, heads, S, dim)
    views of (B, S, heads, dim) storage, as the model passes them, or
    contiguous (``views`` False); v, o and do have the value head dim
    ``vd`` (``hd`` when None: MLA's differ). The wrapper's route
    (``fa_ops.route``) picks the kernel. Either route's result must equal
    a second call's bit for bit; both are held to the plain gradient on
    the same inputs computed in float64 (``grads_close``; with KV = H past
    16 heads, 8 heads at a time), the tensor-core route with its allowance
    for P and dS rounded to bf16 (``bwd_rounding_terms``). Timed beside
    PyTorch's SDPA backward (its autograd gradient on the same inputs);
    the bound is the inputs' (bf16 tensor products for bf16, on either
    route; three TF32 products a product for f32), with the f32 SIMT bound
    beside it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vd = hd if vd is None else vd

    def act(heads, s, dim=hd):
        x = torch.randn(b, s, heads, dim, generator=g, device=dev,
                        dtype=dtype)
        return x.transpose(1, 2) if views else \
            x.transpose(1, 2).contiguous()
    q, k, v = act(h, sq), act(kv, sk), act(kv, sk, vd)
    o = fa_ops.flash_attention(q, k, v, causal)
    if not views:
        o = o.contiguous()
    do = act(h, sq, vd)
    route = fa_ops.route(dtype, hd, vd)
    counter = "bwd_tc_launches" if route == "tc" else "bwd_launches"
    before = getattr(fa_ops, counter)
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, causal)
    if getattr(fa_ops, counter) != before + 1:
        fail(f"flash_attention_bwd: the {route} route's kernel did not "
             f"launch")
    dims = f"{hd}" if vd == hd else f"{hd}/{vd}"
    shape = (f"({b},{h},{kv},{sq},{sk},{dims}) {str(dtype)[6:]} "
             + ("causal" if causal else "full")
             + ("" if views else ", contiguous"))
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, causal)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"flash_attention_bwd ({route}) {shape}: two calls on the same "
             f"inputs differ")
    del again
    if h == kv:
        group_sum_path(torch, fa_ops, q, k, v, o, do, causal, got,
                       f"flash_attention_bwd ({route}) {shape}")
    plain = fa_ref.flash_attention_bwd_ref
    if kv == h and h > 16:
        plain = bwd_heads_at_a_time(torch, plain, 8)
    want = plain(*(t.double() for t in (q, k, v, o, do)), causal)
    p_rounding = bwd_rounding_terms(torch, q, k, v, o, do, causal) \
        if route == "tc" else None
    err, tol, worst = grads_close(torch, got, want,
                                  f"flash_attention_bwd ({route}) {shape}",
                                  p_rounding)
    del p_rounding
    exact = all(bool(torch.equal(x, w.to(x.dtype)))
                for x, w in zip(got, want))
    del got, want
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    # The five products of the gradient (S recomputed, dP, dV, dQ, dK), 2
    # dim flops a live (query head, key) pair each, dim the qk head dim
    # for S, dQ and dK and the value head dim for dP and dV; in f32 three
    # TF32 products each (the 3xTF32 split), in bf16 one bf16 product each.
    ops = 2 * (3 * hd + 2 * vd) * b * h * pairs
    f32 = dtype == torch.float32
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, is_causal=causal, enable_gqa=True)
    # Each input read once and each output written once: q, o, do, dq on
    # the query side; k, v, dk, dv on the key side.
    rec = dict(shape=shape, exact=exact, max_abs_err=err, tol=tol,
               worst=worst,
               bytes=2 * (hd + vd) * (b * h * sq + b * kv * sk)
               * q.element_size(),
               ops=3 * ops if f32 else ops,
               peak=PEAK_TF32_PER_S if f32 else PEAK_BF16_PER_S,
               f32_simt_ms=ops / PEAK_F32_PER_S * 1e3, library_eager=True,
               library=lambda: torch.autograd.grad(
                   lib_out, (qr, kr, vr), do, retain_graph=True))
    return rec, (lambda: fa_ops.flash_attention_bwd(q, k, v, o, do, causal)), \
        (lambda: plain(q, k, v, o, do, causal))


def check_decode_bwd(torch, dev, dec_ops, dec_ref, b, h, kv, s, hd, dtype,
                     pos, seed, empty=()):
    """K6's backward kernel vs its plain version on (B, S, KV, hd) caches
    passed as (B, KV, S, hd) views; ``pos`` as in ``check_decode``, then
    the requests of ``empty`` set to cache_pos = 0 (their gradients all
    zero). Called twice, one launch a call, the two results equal bit for
    bit. Timed beside SDPA's autograd backward on the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev, dtype=dtype)[:, 0]
    ck, cv = (torch.randn(b, s, kv, hd, generator=gen, device=dev,
                          dtype=dtype).transpose(1, 2) for _ in range(2))
    do = torch.randn(b, h, hd, generator=gen, device=dev, dtype=dtype)
    if isinstance(pos, tuple):
        pos = torch.randint(*pos, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    else:
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    for i in empty:
        pos[i] = 0
    o = dec_ops.decode_attention(q, ck, cv, pos)
    shape = (f"B={b} H={h} KV={kv} S={s} hd={hd} {str(dtype)[6:]} "
             f"pos {int(pos.min())}..{int(pos.max())}"
             + (f", {len(empty)} empty" if empty else ""))
    got = []
    for _ in range(2):
        before = dec_ops.bwd_launches
        got.append(dec_ops.decode_attention_bwd(q, ck, cv, pos, o, do))
        if dec_ops.bwd_launches != before + 1:
            fail("decode_attention_bwd: the kernel did not launch once a "
                 "call")
    if not all(torch.equal(x, y) for x, y in zip(*got)):
        fail(f"decode_attention_bwd {shape}: two calls on the same inputs "
             f"differ")
    got = got[0]
    wide = torch.float32 if dtype == torch.float32 else torch.float64
    want = dec_ref.decode_attention_bwd_ref(
        q.to(wide), ck.to(wide), cv.to(wide), pos, o.to(wide), do.to(wide))
    err, tol, worst = grads_close(torch, got, want,
                                  f"decode_attention_bwd {shape}")
    for i in empty:
        if got[0][i].any() or got[1][i].any() or got[2][i].any():
            fail(f"decode_attention_bwd {shape}: request {i} has no live "
                 f"position but a gradient")
    exact = all(bool(torch.equal(x, w.to(x.dtype)))
                for x, w in zip(got, want))
    del got, want
    live = int(pos.clamp(max=s).sum())
    elt = q.element_size()
    mask = (torch.arange(s, device=dev)[None, :] < pos[:, None])[:, None,
                                                                  None]
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, ck, cv))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qr[:, :, None], kr, vr, attn_mask=mask, enable_gqa=True)
    # Bytes: q, o, do in, the live positions of both caches in, dq and
    # both cache-sized cotangents out. Operations: S recomputed, dP, dV,
    # dK and dq, 2 hd flops a (query head, live position) pair each.
    rec = dict(shape=shape, exact=exact, max_abs_err=err, tol=tol,
               worst=worst,
               bytes=(4 * b * h * hd + 2 * kv * hd * live
                      + 2 * b * kv * s * hd) * elt + 4 * b,
               ops=10 * hd * (h // kv) * kv * live,
               peak=PEAK_BF16_PER_S if dtype == torch.bfloat16
               else PEAK_F32_PER_S, library_eager=True,
               library=lambda: torch.autograd.grad(
                   lib_out, (qr, kr, vr), do[:, :, None], retain_graph=True))
    return rec, (lambda: dec_ops.decode_attention_bwd(q, ck, cv, pos, o, do)), \
        (lambda: dec_ref.decode_attention_bwd_ref(q, ck, cv, pos, o, do))


def kitti_frames(np, api, scenes, n: int, seed: int = 0):
    """``n`` kitti-urban frames at KITTI's point count (stream seed 0):
    (N, 4) points with an intensity column from a seeded generator, the
    ground-truth boxes and flags and the (H, W) int32 instance-id image, as
    numpy arrays; and the stream's calibration (Tr, P)."""
    scn = api.scenario("kitti-urban", seed=0, **KITTI)
    rng = np.random.default_rng(seed)
    stream = scenes.SceneStream(scn.scene, seed=0)
    out = []
    for fr in stream.frames(n):
        inten = rng.uniform(0, 1, (len(fr.points), 1))
        out.append((np.concatenate([fr.points, inten], 1).astype(np.float32),
                    fr.gt_boxes.astype(np.float32), fr.gt_valid,
                    fr.label_img.astype(np.int32)))
    return out, (stream.tr.astype(np.float32), stream.p.astype(np.float32))


def pillar_special_inputs(np, seed: int = 0):
    """K4's ``specials`` case as numpy arrays (feats (N, C) f32, ids (N,)
    i32, mask (N,) bool, G): +-0, +-inf, NaN of either sign, subnormals
    and the smallest normals sprinkled over normal values; pillars 0-7 hold
    only negative values, pillar 8 only -inf, pillar 9 only zeros and
    subnormals; pillar G-1 is occupied; kept points with ids at or past G
    are dropped. C = 32: the 16-byte path. ``tests/test_torch_pillar_
    scatter.py`` holds the plain version to JAX's on these inputs."""
    rng = np.random.default_rng(seed)
    n, c, g = 4096, 32, 256
    f = rng.normal(size=(n, c)).astype(np.float32)
    idx = rng.integers(10, g, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.9
    tiny = np.finfo(np.float32).tiny
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40,
                         -1e-40, 1e-45, -1e-45, tiny, -tiny], np.float32)
    hit = rng.uniform(size=(n, c)) < 0.1
    f[hit] = rng.choice(specials, size=int(hit.sum()))
    idx[48:448] = rng.integers(0, 8, 400)          # all-negative pillars
    f[48:448] = -np.abs(f[48:448])
    idx[:16], valid[:16], f[:16] = 8, True, -np.inf
    idx[16:32], valid[16:32] = 9, True
    f[16:32] = rng.choice(specials[[0, 1, 6, 7, 8, 9]], size=(16, c))
    idx[32:40], valid[32:40] = g - 1, True
    idx[40:44], valid[40:44] = [g, g + 3, g + 100, 2 ** 31 - 1], True
    return f, idx, valid, g


def pillar_inputs(torch, np, dev, detector3d, kitti, kind: str, seed: int):
    """K4's inputs on the card: (feats, ids, mask, G, cotangent, label).
    ``kitti``: the real pillar ids of a kitti-urban frame under the default
    PillarConfig and ReLU'd PointNet features from seeded weights (ties at
    0, as on the detector's path); ``sorted``: the same points sorted by
    pillar; ``dense``: N=4096 points in 256 pillars, C=64; ``invalid``:
    every point masked out; ``ties``: ReLU'd features rounded to 0.1, so
    most channels hold several equal maxima; ``specials``:
    ``pillar_special_inputs``; ``one-pillar``: every kept point in one
    pillar (the most contention, the most combining); ``rows-c7``: rows of
    7 channels; ``rows-c40``: rows of 40 channels (the backward's second
    mask word partial); ``unaligned``: rows at a base 4 bytes past a
    16-byte boundary."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind in ("kitti", "sorted"):
        cfg = detector3d.PillarConfig()
        pts = torch.from_numpy(kitti[0][0]).to(dev)
        f9, idx, valid = detector3d.pillarize(
            cfg, pts, torch.ones(len(pts), dtype=torch.bool, device=dev))
        w = torch.randn((9, cfg.feat_dim), generator=g, device=dev) / 3
        feats = torch.relu(f9 @ w).contiguous()
        n_pillars = cfg.grid_h * cfg.grid_w
        if kind == "sorted":
            order = torch.sort(idx, stable=True).indices
            feats, idx, valid = feats[order], idx[order], valid[order]
    elif kind == "specials":
        feats, idx, valid, n_pillars = (
            torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
            for a in pillar_special_inputs(np, seed))
    else:
        n, c, n_pillars = {"dense": (4096, 64, 256),
                           "invalid": (4096, 32, 1024),
                           "ties": (8192, 32, 512),
                           "one-pillar": (8192, 32, 1024),
                           "rows-c7": (4096, 7, 512),
                           "rows-c40": (4096, 40, 512),
                           "unaligned": (4096, 32, 512)}[kind]
        if kind == "unaligned":
            feats = torch.randn((n * c + 1,), generator=g,
                                device=dev)[1:].view(n, c)
        else:
            feats = torch.randn((n, c), generator=g, device=dev)
        if kind == "ties":
            feats = torch.round(torch.relu(feats) * 10) / 10
        idx = torch.randint(0, n_pillars, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        if kind == "one-pillar":
            idx.fill_(n_pillars // 3)
        valid = torch.rand((n,), generator=g, device=dev) < (
            0.0 if kind == "invalid" else 0.9)
    ct = torch.randn((n_pillars, feats.shape[1]), generator=g, device=dev)
    return feats, idx, valid, n_pillars, ct, kind


# Points a warp of K4's forward takes at a time (kBatch in
# src/repro_torch/csrc/pillar_scatter.cu).
K4_BATCH = 8


def combining(torch, idx, kept) -> str:
    """What the forward's combining can save on these ids, counted on the
    host: the share of adjacent kept points in the same pillar, and the
    row atomics the kernel sends (one for each run of consecutive kept
    points in one pillar, within a warp's batch of K4_BATCH points)
    against one a kept point."""
    ids = torch.where(kept, idx, -1).cpu()
    kid = ids[ids >= 0]
    adjacent = float((kid[1:] == kid[:-1]).float().mean()) \
        if len(kid) > 1 else 0.0
    batch = torch.cat([ids, ids.new_full(((-len(ids)) % K4_BATCH,), -1)])
    batch = batch.view(-1, K4_BATCH)
    head = batch >= 0
    head[:, 1:] &= batch[:, 1:] != batch[:, :-1]
    sends = int(head.sum())
    return (f"{adjacent:.4f} of adjacent kept points share a pillar; "
            f"{sends} row atomics for {len(kid)} kept points "
            f"({sends / max(len(kid), 1):.4f})")


def check_pillar_scatter(torch, ps_ops, ps_ref, inputs, backward: bool):
    """K4's forward (equal to its plain version value for value) or its
    backward (bit for bit) on the card. The library yardstick is PyTorch's
    ``scatter_reduce(..., "amax")`` (dropped points sent to a spare row)
    and, for the backward, autograd's gradient of it, timed eagerly."""
    f, idx, valid, n_pillars, ct, kind = inputs
    n, c = f.shape
    kept = valid & (idx >= 0) & (idx < n_pillars)
    n_kept = int(kept.sum())
    per_pillar = torch.bincount(idx[kept].long(), minlength=n_pillars)
    occupied = int((per_pillar > 0).sum())
    shape = (f"N={n} C={c} G={n_pillars} ({kind}, {n_kept} kept in "
             f"{occupied} pillars, at most {int(per_pillar.max())} a "
             f"pillar; {combining(torch, idx, kept)})")
    out = ps_ops.pillar_scatter(f, idx, valid, n_pillars)
    want = ps_ref.pillar_scatter_ref(f, idx, valid, n_pillars)
    if not torch.equal(out, want):
        fail(f"pillar_scatter {shape}: differs from the plain version")
    lib_idx = torch.where(kept, idx, n_pillars).long()[:, None].expand(n, c)
    spare = torch.full((n_pillars + 1, c), -torch.inf, device=f.device)
    if not backward:
        # Bytes: the kept points' features, every id and mask in, the grid
        # out (a dropped point's row is never read). Operations: one max a
        # kept value.
        rec = dict(shape=shape, exact=True, max_abs_err=0.0,
                   tol="equal by value",
                   bytes=n_kept * c * 4 + n * 5 + n_pillars * c * 4,
                   ops=n_kept * c,
                   library=lambda: spare.scatter_reduce(0, lib_idx, f,
                                                        "amax"))
        return rec, (lambda: ps_ops.pillar_scatter(f, idx, valid,
                                                   n_pillars)), \
            (lambda: ps_ref.pillar_scatter_ref(f, idx, valid, n_pillars))
    safe = torch.where(kept, idx, 0).long()
    ties = int((kept[:, None] & (f == want[safe])).sum())
    shape += f"; {ties} tied values ({ties / max(n * c, 1):.4f} of the grad)"
    got = ps_ops.pillar_scatter_bwd(f, idx, valid, out, ct)
    ref = ps_ref.pillar_scatter_bwd_ref(f, idx, valid, want, ct)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        err = float((got - ref).abs().max())
        fail(f"pillar_scatter_bwd {shape}: not bit-equal to the plain "
             f"version (max abs err {err})")
    fx = f.detach().clone().requires_grad_()
    lib_out = spare.scatter_reduce(0, lib_idx, fx, "amax")
    lib_ct = torch.cat([ct, ct.new_zeros((1, c))])
    # Bytes: the kept points' features, every id and mask, the occupied
    # pillars' rows of the grid and its cotangent in, the whole gradient
    # out. Operations: a compare, a count, a multiply a value.
    rec = dict(shape=shape, exact=True, max_abs_err=0.0, tol="bit for bit",
               bytes=(n * c * 4 + n_kept * c * 4 + n * 5
                      + 2 * occupied * c * 4),
               ops=3 * n_kept * c, library_eager=True,
               library=lambda: torch.autograd.grad(lib_out, fx, lib_ct,
                                                   retain_graph=True))
    return rec, (lambda: ps_ops.pillar_scatter_bwd(f, idx, valid, out, ct)), \
        (lambda: ps_ref.pillar_scatter_bwd_ref(f, idx, valid, want, ct))


def measure(torch, rec, kern, plain) -> None:
    """Time a kernel at the serving shape: device ms from CUDA-graph replays
    (as many calls a graph as fit ~100 ms, at most 50), eager ms per call;
    its plain version as a graph of 50 calls too, or, where the record
    carries a library yardstick (the attention kernels, whose plain
    versions hold GBs of scores; K4, whose plain forward masks with a host
    sync), eagerly over a few calls; the library call from graph replays,
    or eagerly where the record says so (an autograd backward). The
    kernels (and memsets) that the kernel's and the library's calls
    launch, with device time a call, come from a profile."""
    def reps(fn):
        est = eager_ms(fn, torch, runs=3, warmup=1)
        return est, max(1, min(50, int(100 / max(est, 1e-3))))
    est, n = reps(kern)
    rec["kernel_ms"] = graph_ms(kern, torch, reps=n)
    if "rounds_max" in rec:
        rec["us_per_round"] = rec["kernel_ms"] * 1e3 / rec["rounds_max"]
    if "skeleton" in rec:
        rec["skeleton_ms"] = graph_ms(rec.pop("skeleton"), torch, reps=n)
    rec["kernel_eager_ms"] = eager_ms(
        kern, torch, runs=max(5, min(100, int(1000 / max(est, 1e-2)))))
    rec["kernels"] = device_kernels(torch, kern)
    library = rec.pop("library", None)
    if rec.pop("plain_eager", False):
        # The plain version synchronises with the host (the auction's end
        # check), which a graph cannot hold: timed eagerly.
        rec["plain_ms"] = rec["plain_eager_ms"] = eager_ms(
            plain, torch, runs=3, warmup=1)
        return
    if library is None:
        rec["plain_ms"] = graph_ms(plain, torch)
        rec["plain_eager_ms"] = eager_ms(plain, torch)
        return
    rec["plain_ms"] = rec["plain_eager_ms"] = eager_ms(plain, torch, runs=3,
                                                       warmup=1)
    if rec.pop("library_eager", False):
        rec["library_ms"] = eager_ms(library, torch, runs=20, warmup=3)
    else:
        rec["library_ms"] = graph_ms(library, torch, reps=reps(library)[1])
    rec["library_kernels"] = device_kernels(torch, library, calls=3)


def lm_run(torch, lm, decode, cfg, p, tokens, dec_tokens, max_len, dev,
           cross=None, **inputs):
    """Prefill logits and the logits of one decode step per row of
    ``dec_tokens``, from empty caches of ``max_len`` positions. ``inputs``:
    ``lm.forward``'s other inputs (``embeds``, ``positions``,
    ``enc_embeds``; ``tokens`` may then be None); ``cross``: the
    encoder-decoder's cross caches (cross_k, cross_v), copied into the
    decode state (no code fills them, as in JAX)."""
    logits = lm.forward(p, cfg, None if tokens is None else tokens.to(dev),
                        **{k: v.to(dev) for k, v in inputs.items()})
    state = decode.init_decode(cfg, dec_tokens.shape[1], max_len, dev)
    for k, v in zip(("cross_k", "cross_v"), cross or ()):
        state.caches[k].copy_(v)
    steps = []
    for t in dec_tokens:
        lg, state = decode.decode_step(p, cfg, state, t.to(dev))
        steps.append(lg)
    return logits, torch.stack(steps)


def lm_compare(torch, got, want, tol: float, what: str) -> float:
    """Prefill and decode logits finite, of the expected shapes, and within
    ``tol`` (absolute and relative); returns the largest difference."""
    err = 0.0
    for name, g, w in zip(("prefill", "decode"), got, want):
        g, w = g.float().cpu(), w.float().cpu()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{what}: {name} logits {tuple(g.shape)} (want "
                 f"{tuple(w.shape)}) or not finite")
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=tol, atol=tol):
            fail(f"{what}: {name} logits off by {err} (tolerance {tol})")
    return err


def golden_lm(torch, np, dev, cfg, golden, convert, lm, decode, params
              ) -> float:
    """The f32 SMOKE config on the card with a JAX golden's weights
    (``tests/goldens/lm_*_smoke.npz``): prefill (from its tokens, or its
    embeddings and M-RoPE positions; with its encoder embeddings) and four
    decode steps (over its cross caches, where it has them) within 1e-5 of
    its logits; returns the largest difference."""
    with np.load(golden) as f:
        gold = {k: torch.from_numpy(f[k]) for k in f.files}
    tree = params.from_leaves((tuple(k.split("/")[1:]), v.numpy())
                              for k, v in gold.items()
                              if k.startswith("params/"))
    cross = (gold["cross_k"], gold["cross_v"]) if "cross_k" in gold \
        else None
    logits, steps = lm_run(torch, lm, decode, cfg,
                           convert.params_from_jax(tree, cfg, dev),
                           gold.get("tokens"), gold["decode_tokens"], 32,
                           dev, cross, **{k: gold[k] for k in (
                               "embeds", "positions", "enc_embeds")
                               if k in gold})
    return lm_compare(torch, (logits, steps),
                      (gold["logits"], gold["decode_logits"]), 1e-5,
                      f"{cfg.name} on the card vs {golden.name}")


def rescale_attention(stack, cfg) -> None:
    """Scale a stack's attention weights in place as if JAX's fanin init
    took fan_in = d_model (and H*hd for wo).

    The JAX package's fanin init takes fan_in = shape[-2] of the 3-d
    attention weights (the head count, or hd for wo): at full width the
    attention scores then have a std of ~360 and the softmax is nearly
    one-hot, so a 1-ulp change of the weights moves the logits by ~1e-2
    and no two summation orders agree to 1e-4. Rescaled, the scores have
    a std of ~1 and a 1-ulp change moves the logits by ~1e-5. An
    encoder-decoder's decoder stack has its cross attention rescaled
    too."""
    for attn in (stack[k] for k in ("attn", "cross") if k in stack):
        for name in ("wq", "wk", "wv"):
            attn[name].mul_((attn[name].shape[-2] / cfg.d_model) ** 0.5)
        attn["wo"].mul_((attn["wo"].shape[-2] / cfg.d_head_total) ** 0.5)


def recorded_routes(layers, run):
    """``run()`` with every ``layers.moe_route`` call recorded: returns
    (run's result, [(probs (T, E) f32, experts (T, k))] in call order)."""
    calls, route = [], layers.moe_route

    def recording(p, xt, cfg):
        probs, topw, topi = route(p, xt, cfg)
        calls.append((probs, topi))
        return probs, topw, topi
    layers.moe_route = recording
    try:
        return run(), calls
    finally:
        layers.moe_route = route


def route_gap(torch, calls, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over the recorded calls: how near the routing came to a
    tie."""
    return min(float((w[:, k - 1] - w[:, k]).min()) for w in (
        torch.sort(probs.detach().float(), dim=-1, descending=True)[0]
        for probs, _ in calls))


def rescale_mla(stack) -> None:
    """Scale a stack's MLA weights in place as if JAX's fanin init took
    the contracted dims as fan_in (``rescale_attention``'s reason): its
    3-d weights take fan_in = shape[-2], the head count (wq_b, wk_b, wv_b)
    or the value dim (wo), where the products contract q_lora, kv_lora or
    heads x value dim. Rescaled, the scores have a std of ~1."""
    attn = stack["attn"]
    for name in ("wq_b", "wk_b", "wv_b"):     # (L, in, H, dim)
        attn[name].mul_((attn[name].shape[-2] / attn[name].shape[1]) ** 0.5)
    wo = attn["wo"]                            # (L, H, v, D)
    wo.mul_((wo.shape[-2] / (wo.shape[1] * wo.shape[2])) ** 0.5)


def decode_kernel(cfg):
    """The decode attention kernel of a config's serving step: (its launch
    counter, the names of its passes in a profile)."""
    if cfg.attn_kind == "mla":
        return "mla_decode_attention", ("mla_decode_tc_kernel",
                                        "mla_decode_merge_kernel")
    return "decode_attention", ("decode_partial_kernel", "decode_g1_kernel",
                                "decode_combine_kernel")


def check_decode_layout(torch, label: str, cfg, n_decode: int) -> None:
    """A bf16 serving phase's K6 launches all went through the layout its
    shapes pick (``decode_attention.ops.layout``: G = 1 its own)."""
    if cfg.attn_kind == "mla":
        return
    from repro_torch.kernels.decode_attention import ops as dec_ops
    kind = dec_ops.layout(torch.bfloat16, cfg.head_dim,
                          cfg.n_heads // cfg.n_kv_heads)
    want = {k: n_decode if k == kind else 0 for k in dec_ops.layout_launches}
    if dec_ops.layout_launches != want:
        fail(f"{label} C decode layouts {dec_ops.layout_launches} != {want}")
    print(f"{label} C: K6 launches by layout {dec_ops.layout_launches}",
          flush=True)


def check_moe(torch, np, dev, kernels, lm_configs, convert, lm, decode,
              params, layers, label: str, arch: str, golden: Path,
              b_layers: int, seed: int):
    """Phases A (the SMOKE config in f32 with the JAX golden's weights,
    against its logits) and B (full width, the dense first layer and one
    MoE layer, f32, attention weights rescaled (``rescale_attention``, or
    ``rescale_mla`` for MLA): the card against the CPU within 1e-4, every
    token routed to the same experts) of a moe architecture (MoE:
    moonshot, MLA: deepseek-v2). Both are the f32 serving path: prefill
    through the 3xTF32 flash route, decode through ``decode_kernel``'s
    kernel (MLA's SIMT instance), one launch a layer a prefill or step;
    returns those counts by phase, {counter: {"<label> A": n, ...}},
    checked."""
    from repro_torch.kernels.mla_decode_attention import ops as mla_ops
    f32 = torch.float32
    counts, routes = {}, {}
    # -- A: SMOKE on the card vs the JAX golden ------------------------------
    kernels.reset_launch_counts()
    cfg = dataclasses.replace(lm_configs.get_smoke(arch), dtype=f32)
    err = golden_lm(torch, np, dev, cfg, golden, convert, lm, decode, params)
    print(f"{label} A: {cfg.name} f32 prefill + 4 decode steps on the card "
          f"match {golden.name} (max abs err {err:.3g}, tolerance 1e-5)",
          flush=True)
    counts[f"{label} A"] = (kernels.launch_counts(), cfg.n_layers)
    routes[f"{label} A"] = dict(mla_ops.route_launches)
    if cfg.attn_kind == "mla":
        counts[f"{label} A bf16"], routes[f"{label} A bf16"] = mla_smoke_bf16(
            torch, np, dev, kernels, mla_ops, lm_configs, convert, lm,
            decode, params, layers, label, arch, golden)

    # -- B: full width, 2 layers, f32: the card vs the CPU -----------------
    kernels.reset_launch_counts()
    cfg = dataclasses.replace(lm_configs.get(arch), n_layers=b_layers,
                              dtype=f32)
    p_card = params.init_params(lm.model_defs(cfg),
                                torch.Generator(device=dev).manual_seed(seed),
                                dev)
    for key, _ in lm.stacks(cfg):
        if cfg.attn_kind == "mla":
            rescale_mla(p_card[key])
        else:
            rescale_attention(p_card[key], cfg)
    p_cpu = params.tree_map(lambda t: t.cpu(), p_card)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (LM_B_BATCH, LM_B_S), generator=gen,
                           dtype=torch.int32)
    dec_tokens = torch.randint(0, cfg.vocab, (4, LM_B_BATCH), generator=gen,
                               dtype=torch.int32)
    t0 = time.perf_counter()
    card, card_routes = recorded_routes(layers, lambda: lm_run(
        torch, lm, decode, cfg, p_card, tokens, dec_tokens, 512, dev))
    t_card = time.perf_counter() - t0
    cpu, cpu_routes = recorded_routes(layers, lambda: lm_run(
        torch, lm, decode, cfg, p_cpu, tokens, dec_tokens, 512,
        torch.device("cpu")))
    counts[f"{label} B"] = (kernels.launch_counts(), b_layers)
    routes[f"{label} B"] = dict(mla_ops.route_launches)
    gaps = (route_gap(torch, card_routes, cfg.top_k),
            route_gap(torch, cpu_routes, cfg.top_k))
    if len(card_routes) != len(cpu_routes):
        fail(f"{label} B: {len(card_routes)} MoE calls on the card, "
             f"{len(cpu_routes)} on the CPU")
    n_tokens = 0
    for i, ((_, got), (probs, want)) in enumerate(zip(card_routes,
                                                      cpu_routes)):
        differ = (got.cpu() != want).any(-1)
        if bool(differ.any()):
            w = torch.sort(probs, dim=-1, descending=True)[0]
            gap = (w[:, cfg.top_k - 1] - w[:, cfg.top_k])[differ]
            fail(f"{label} B: MoE call {i}: {int(differ.sum())} tokens "
                 f"routed to other experts on the card than on the CPU "
                 f"(their k-th to (k+1)-th probability gaps on the CPU: "
                 f"{gap.tolist()[:8]})")
        n_tokens += want.shape[0]
    err = lm_compare(torch, card, cpu, 1e-4,
                     f"{cfg.name} x{b_layers} layers on the card vs the CPU")
    print(f"{label} B: {cfg.name} at full width ({b_layers} layers: "
          f"{cfg.first_dense} dense + {b_layers - cfg.first_dense} MoE, "
          f"f32) B={LM_B_BATCH} S={LM_B_S} prefill + 4 decode steps: the card"
          f" matches the CPU (max abs err {err:.3g}, tolerance 1e-4); the "
          f"routing of {n_tokens} tokens over {len(cpu_routes)} MoE calls is "
          f"equal; smallest gap between the k-th and (k+1)-th router "
          f"probability {gaps[0]:.3g} (card), {gaps[1]:.3g} (CPU); card "
          f"{t_card:.1f} s, CPU {time.perf_counter() - t0 - t_card:.1f} s",
          flush=True)
    del p_card, p_cpu, card, cpu, card_routes, cpu_routes
    counter = decode_kernel(cfg)[0]
    out = {"flash_attention": {}, counter: {}}
    for phase, (launches, n_layers) in counts.items():
        expect = dict.fromkeys(launches, 0)
        expect.update({"flash_attention": n_layers, counter: 4 * n_layers})
        if launches != expect:
            fail(f"{phase} launch counts {launches} != {expect}")
        names = ""
        if cfg.attn_kind == "mla":
            # SMOKE (A, in f32 and bf16) at MLA's (24, 16) / (16, 8), full
            # width (B) at (192, 128) / (512, 64): the instances of each.
            small = not phase.endswith("B")
            inst = "simt" if small else "tf32x3"
            want = dict.fromkeys(mla_ops.route_launches, 0)
            want[inst] = 4 * n_layers
            if routes[phase] != want:
                fail(f"{phase}: MLA decode launches by instance "
                     f"{routes[phase]} != {want}")
            dims = ("qk 24 / value 16", "(16, 8)") if small else \
                ("qk 192 / value 128, persistent", "(512, 64)")
            names = (f" (flash_attention: the tf32x3 instance at {dims[0]};"
                     f" mla_decode_attention: the {inst} instance at "
                     f"{dims[1]}, {routes[phase][inst]} launches)")
        print(f"{phase}: launches {launches}{names}", flush=True)
        for k in out:
            out[k][phase] = launches[k]
    return out


def mla_smoke_bf16(torch, np, dev, kernels, mla_ops, lm_configs, convert,
                   lm, decode, params, layers, label, arch, golden):
    """MLA A in its own dtype: the SMOKE config in bf16 (its default) with
    the golden's weights, prefill and four decode steps on the card held
    to the port's CPU run within the bf16 tolerance of
    ``tests/test_torch_mla.py`` (3e-2, absolute and relative, of the
    logits' own scale where it passes 1); K5 takes its `tf32x3` bf16
    (24, 16) instance. Returns the launch counts and the MLA decode's
    launches by instance."""
    cfg = lm_configs.get_smoke(arch)
    if cfg.dtype != torch.bfloat16:
        fail(f"{label} A bf16: {cfg.name}'s SMOKE dtype is {cfg.dtype}")
    with np.load(golden) as f:
        gold = {k: f[k] for k in f.files}
    tree = params.from_leaves((tuple(k.split("/")[1:]), v)
                              for k, v in gold.items()
                              if k.startswith("params/"))
    tokens = torch.from_numpy(gold["tokens"])
    dec_tokens = torch.from_numpy(gold["decode_tokens"])
    kernels.reset_launch_counts()
    card, card_routes = recorded_routes(layers, lambda: lm_run(
        torch, lm, decode, cfg, convert.params_from_jax(tree, cfg, dev),
        tokens, dec_tokens, 32, dev))
    launches = kernels.launch_counts()
    by_instance = dict(mla_ops.route_launches)
    cpu, cpu_routes = recorded_routes(layers, lambda: lm_run(
        torch, lm, decode, cfg, convert.params_from_jax(tree, cfg, "cpu"),
        tokens, dec_tokens, 32, torch.device("cpu")))
    same_routes = len(card_routes) == len(cpu_routes) and all(
        torch.equal(got.cpu(), want) for (_, got), (_, want)
        in zip(card_routes, cpu_routes))
    err = 0.0
    for name, g, w in zip(("prefill", "decode"), card, cpu):
        g, w = g.float().cpu(), w.float().cpu()
        tol = 3e-2 * max(1.0, float(w.abs().max()))
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{label} A bf16: {name} logits {tuple(g.shape)} (want "
                 f"{tuple(w.shape)}) or not finite")
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=tol, atol=tol):
            fail(f"{label} A bf16: {name} logits off by {err} (tolerance "
                 f"{tol:.3g}); routing "
                 f"{'equal' if same_routes else 'differs'} on the card and "
                 f"the CPU")
    print(f"{label} A bf16: {cfg.name} bf16 prefill + 4 decode steps on the "
          f"card match the port's CPU run (max abs err {err:.3g}, tolerance "
          f"3e-2 of the logits' scale); routing "
          f"{'equal' if same_routes else 'differs'}, smallest gap between "
          f"the k-th and (k+1)-th router probability "
          f"{route_gap(torch, card_routes, cfg.top_k):.3g} (card)",
          flush=True)
    return (launches, cfg.n_layers), by_instance


def serve_moe(torch, dev, kernels, lm_configs, lm, decode, params, layers,
              label: str, arch: str, n_layers: int, seed: int):
    """Phase C of a moe architecture: at full width in bf16 on the card,
    ``n_layers`` layers (seeded weights drawn a layer at a time by
    ``lm.init_cast_params``), LM C's traffic (prefill B=PREFILL_B,
    S=PREFILL_S, median of 3 after a warm-up, its expert loads and drops
    printed; DECODE_STEPS greedy decode steps at B=DECODE_B over a
    DECODE_MAX-position cache with ragged positions from DECODE_POS_LO).
    Launches checked (K5 `tc` one a layer a prefill, ``decode_kernel``'s
    kernel one a layer a step, nothing else), one step under sync debug
    mode "error", a profile of a prefill and of 4 steps. Returns the two
    counts."""
    cfg = dataclasses.replace(lm_configs.get(arch), n_layers=n_layers)
    counter, decode_names = decode_kernel(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = lm.init_cast_params(cfg, gen)   # matrices bf16; norms stay f32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_params = params.param_count(lm.model_defs(cfg))
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=dev, dtype=torch.int32)
    state = decode.init_decode(cfg, DECODE_B, DECODE_MAX, dev)
    caches = [c for pair in state.caches.values() for c in pair.values()]
    for cache in caches:
        cache.normal_(generator=gen)
    state = state._replace(cache_pos=torch.randint(
        DECODE_POS_LO, DECODE_MAX - DECODE_STEPS - 8, (DECODE_B,),
        generator=gen, device=dev, dtype=torch.int32))
    live = int(state.cache_pos.sum())
    cache_gb = sum(c.numel() * c.element_size() for c in caches) / 1e9
    step_tokens = torch.randint(0, cfg.vocab, (DECODE_B,), generator=gen,
                                device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    print(f"{label} C: {cfg.name} ({cfg.n_layers} layers: {cfg.first_dense} "
          f"dense + {cfg.n_layers - cfg.first_dense} MoE, bf16, "
          f"{n_params / 1e9:.3f}B parameters) weights and a "
          f"{DECODE_B}x{DECODE_MAX} cache ({cache_gb:.2f} GB) on the card in "
          f"{time.perf_counter() - t0:.1f} s; cache positions "
          f"{int(state.cache_pos.min())}..{int(state.cache_pos.max())} "
          f"(mean {live / DECODE_B:.0f}); device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    def step():
        nonlocal state, step_tokens
        logits, state = decode.decode_step(p, cfg, state, step_tokens)
        step_tokens = logits.argmax(-1).to(torch.int32)
        return logits

    # Warm-ups, outside the counted run; the prefill's routing recorded.
    _, routes = recorded_routes(layers, lambda: lm.forward(p, cfg, tokens))
    step()
    torch.cuda.synchronize()
    cap = layers.moe_capacity(cfg, PREFILL_B * PREFILL_S)
    loads = torch.stack([torch.bincount(topi.flatten(),
                                        minlength=cfg.n_experts)
                         for _, topi in routes])
    dropped = int((loads - cap).clamp_min(0).sum())
    print(f"{label} C: prefill routing over {len(routes)} MoE layers: the "
          f"busiest expert takes {int(loads.max())} of "
          f"{PREFILL_B * PREFILL_S} tokens (capacity {cap}), the idlest "
          f"{int(loads.min())}; {dropped} of {int(loads.sum())} assignments "
          f"dropped", flush=True)
    del routes, loads
    kernels.reset_launch_counts()
    prefill_ms, step_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        logits = lm.forward(p, cfg, tokens)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if tuple(logits.shape) != (PREFILL_B, PREFILL_S, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{label} C prefill logits {tuple(logits.shape)} or not finite")
    del logits
    for _ in range(DECODE_STEPS):
        t0 = time.perf_counter()
        step_logits = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update({"flash_attention_tc": 3 * cfg.n_layers,
                   counter: DECODE_STEPS * cfg.n_layers})
    if launches != expect:
        fail(f"{label} C launch counts {launches} != {expect}")
    check_decode_layout(torch, label, cfg, launches[counter])
    if tuple(step_logits.shape) != (DECODE_B, cfg.vocab) or \
            not bool(torch.isfinite(step_logits).all()):
        fail(f"{label} C decode logits {tuple(step_logits.shape)} or not "
             f"finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # One step with every synchronising CUDA call an error.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    total_s = sum(step_ms) / 1e3
    print(f"{label} C: prefill B={PREFILL_B} S={PREFILL_S}: median "
          f"{statistics.median(prefill_ms):.2f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in prefill_ms)}), "
          f"{PREFILL_B * PREFILL_S / statistics.median(prefill_ms) * 1e3:.1f}"
          f" tokens/s; decode B={DECODE_B} max_len {DECODE_MAX}: median "
          f"{statistics.median(step_ms):.3f} ms/step (min {min(step_ms):.3f},"
          f" max {max(step_ms):.3f}), {DECODE_B * DECODE_STEPS / total_s:.1f} "
          f"tokens/s over {DECODE_STEPS} steps; launches {launches}; a step "
          f"under sync debug mode \"error\" made no synchronising call; peak "
          f"device memory {peak:.2f} GiB", flush=True)
    print(profile_window(torch, f"{cfg.name} x{cfg.n_layers} prefill "
                         f"B={PREFILL_B} S={PREFILL_S}",
                         lambda: lm.forward(p, cfg, tokens), 1, "prefill",
                         names=("flash_tc_kernel",)), flush=True)
    print(profile_window(torch, f"{cfg.name} x{cfg.n_layers} decode "
                         f"B={DECODE_B}",
                         lambda: [step() for _ in range(4)], 4, "step",
                         names=decode_names), flush=True)
    return {k: launches[k] for k in ("flash_attention_tc", counter)}


def mrope_positions(np, before: int, grid, after: int):
    """(3, S) M-RoPE ids of ``before`` text tokens, an image of grid =
    (rows, cols) patches and ``after`` text tokens, by Qwen2-VL's rule: a
    text token's id is the same on the three streams; the patch at (row,
    col) has (t0, t0 + row, t0 + col), t0 the id after the text before it;
    the text after resumes at the image's largest id + 1."""
    rows, cols = grid
    r, c = np.divmod(np.arange(rows * cols), cols)
    text = np.arange(before)
    tail = before + max(rows, cols) + np.arange(after)
    return np.stack([np.concatenate([text, np.full(rows * cols, before),
                                     tail]),
                     np.concatenate([text, before + r, tail]),
                     np.concatenate([text, before + c, tail])]
                    ).astype(np.int32)


def family_inputs(torch, np, layers, cfg, p, batch: int, seq: int, gen,
                  layout=None):
    """A prefill's inputs on ``p``'s device: (tokens or None,
    ``lm.forward``'s other inputs). dense: tokens; vlm: embeddings (the
    text rows from ``p``'s token table, the image's patches seeded at the
    table's std, 0.02) at the ``layout``'s M-RoPE positions (the same for
    every row); audio: tokens and ``cfg.enc_seq`` frames of seeded encoder
    embeddings."""
    dev = p["embed"]["table"].device
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if cfg.family == "vlm":
        before, (rows, cols), after = layout
        embeds = layers.embed_apply(p["embed"], tokens, cfg)
        embeds[:, before:before + rows * cols] = torch.randn(
            (batch, rows * cols, cfg.d_model), generator=gen,
            device=dev) * 0.02
        pos = torch.from_numpy(mrope_positions(np, before, (rows, cols),
                                               after)).to(dev)
        return None, {"embeds": embeds,
                      "positions": pos[:, None].expand(3, batch, seq)}
    if cfg.family == "dense":
        return tokens, {}
    return tokens, {"enc_embeds": torch.randn(
        (batch, cfg.enc_seq, cfg.d_model), generator=gen, device=dev)}


def family_launches(cfg, prefills: int, steps: int) -> dict:
    """K5's and K6's launches over ``prefills`` prefills and ``steps``
    decode steps: an attention a layer (the encoder-decoder: the
    encoder's, the decoder's self and cross attention in a prefill, self
    and cross in a step)."""
    enc = cfg.family in ("encdec", "audio")
    return {"prefill": prefills * (cfg.n_layers * (2 if enc else 1)
                                   + (cfg.n_enc_layers if enc else 0)),
            "decode": steps * cfg.n_layers * (2 if enc else 1)}


def check_family(torch, np, dev, kernels, lm_configs, convert, lm, decode,
                 params, layers, label: str, arch: str, golden: Path,
                 seed: int):
    """Phases A (the SMOKE config in f32 with the JAX golden's weights:
    prefill and four decode steps within 1e-5 of its logits) and B (full
    width, LM_B_LAYERS layers (audio: as many encoder layers too) in f32,
    attention rescaled (``rescale_attention``: the scores of order 1; the
    cross attention too), prefill at B=LM_B_BATCH, S=LM_B_S (vlm:
    VLM_B_LAYOUT's M-RoPE positions; audio: all enc_seq frames) and four
    decode steps (max_len 512; audio: over seeded cross caches): the card
    against the CPU within 1e-4) of the dense (LM: qwen2.5-3B), vlm (VLM)
    or audio (Audio) family. Both are the f32 serving path: prefill
    through the 3xTF32 flash route, decode through K6; returns the launch
    counts by phase, {counter: {"<label> A": n, ...}}, checked."""
    f32 = torch.float32
    counts = {}
    kernels.reset_launch_counts()
    cfg = dataclasses.replace(lm_configs.get_smoke(arch), dtype=f32)
    err = golden_lm(torch, np, dev, cfg, golden, convert, lm, decode, params)
    print(f"{label} A: {cfg.name} f32 prefill + 4 decode steps on the card "
          f"match {golden.name} (max abs err {err:.3g}, tolerance 1e-5)",
          flush=True)
    counts[f"{label} A"] = (kernels.launch_counts(), cfg)

    kernels.reset_launch_counts()
    cfg = dataclasses.replace(lm_configs.get(arch), dtype=f32,
                              n_layers=LM_B_LAYERS)
    if cfg.n_enc_layers:
        cfg = dataclasses.replace(cfg, n_enc_layers=LM_B_LAYERS)
    p_card = params.init_params(lm.model_defs(cfg),
                                torch.Generator(device=dev).manual_seed(seed),
                                dev)
    rescale_stacks(cfg, p_card, lm)
    p_cpu = params.tree_map(lambda t: t.cpu(), p_card)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens, inputs = family_inputs(torch, np, layers, cfg, p_cpu,
                                   LM_B_BATCH, LM_B_S, gen, VLM_B_LAYOUT)
    # The audio family's cross caches, seeded (JAX's are zeros, never
    # filled).
    cross = tuple(torch.randn(
        (cfg.n_layers, LM_B_BATCH, cfg.enc_seq, cfg.n_kv_heads,
         cfg.head_dim), generator=gen) for _ in range(2)) \
        if cfg.family in ("encdec", "audio") else None
    dec_tokens = torch.randint(0, cfg.vocab, (4, LM_B_BATCH), generator=gen,
                               dtype=torch.int32)
    t0 = time.perf_counter()
    card = lm_run(torch, lm, decode, cfg, p_card, tokens, dec_tokens, 512,
                  dev, cross, **inputs)
    t_card = time.perf_counter() - t0
    cpu = lm_run(torch, lm, decode, cfg, p_cpu, tokens, dec_tokens, 512,
                 torch.device("cpu"), cross, **inputs)
    counts[f"{label} B"] = (kernels.launch_counts(), cfg)
    err = lm_compare(torch, card, cpu, 1e-4,
                     f"{cfg.name} x{LM_B_LAYERS} layers on the card vs the "
                     f"CPU")
    what = f"prefill B={LM_B_BATCH} S={LM_B_S}"
    if cfg.family == "vlm":
        what += (f" from embeddings at M-RoPE positions (text "
                 f"{VLM_B_LAYOUT[0]}, an image {VLM_B_LAYOUT[1][0]}x"
                 f"{VLM_B_LAYOUT[1][1]}, text {VLM_B_LAYOUT[2]})")
    elif cross is not None:
        what += (f" after {LM_B_LAYERS} encoder layers over {cfg.enc_seq} "
                 f"frames, seeded cross caches")
    print(f"{label} B: {cfg.name} at full width ({LM_B_LAYERS} layers, "
          f"f32), {what}, + 4 decode steps: the card matches the CPU (max "
          f"abs err {err:.3g}, tolerance 1e-4; card {t_card:.1f} s, CPU "
          f"{time.perf_counter() - t0 - t_card:.1f} s)", flush=True)
    del p_card, p_cpu, card, cpu
    out = {"flash_attention": {}, "decode_attention": {}}
    for phase, (launches, c) in counts.items():
        n = family_launches(c, 1, 4)
        expect = dict.fromkeys(launches, 0)
        expect.update(flash_attention=n["prefill"],
                      decode_attention=n["decode"])
        if launches != expect:
            fail(f"{phase} launch counts {launches} != {expect}")
        print(f"{phase}: launches {launches}", flush=True)
        for k in out:
            out[k][phase] = launches[k]
    return out


def serve_family(torch, np, dev, kernels, lm_configs, lm, decode, params,
                 layers, label: str, arch: str, seed: int):
    """Phase C of the dense (LM: qwen2.5-3B), vlm (VLM) or audio (Audio)
    family: every layer in bf16 on the card (seeded weights drawn a layer
    at a time by ``lm.init_cast_params``). dense: prefill at B=PREFILL_B,
    S=PREFILL_S from tokens, DECODE_STEPS greedy steps at B=DECODE_B over
    a DECODE_MAX cache (LM C's traffic); vlm: the same from embeddings at
    VLM_C_LAYOUT's M-RoPE positions; audio:
    prefill of AUDIO_C_B requests of enc_seq frames and AUDIO_C_S decoder
    tokens, DECODE_STEPS steps at B=AUDIO_C_B over an AUDIO_C_CACHE self
    cache
    and seeded cross caches. Caches seeded, positions ragged; a prefill
    the median of 3 after a warm-up. Launches checked (K5 `tc` and K6 as
    ``family_launches`` counts, nothing else), one step under sync debug
    mode "error", a profile of 4 steps. Returns the two counts."""
    cfg = lm_configs.get(arch)
    vlm, enc = cfg.family == "vlm", cfg.family in ("encdec", "audio")
    batch, seq, dec_b, max_len, lo = (
        (AUDIO_C_B, AUDIO_C_S, AUDIO_C_B, AUDIO_C_CACHE, AUDIO_POS_LO) if enc
        else (PREFILL_B, PREFILL_S, DECODE_B, DECODE_MAX, DECODE_POS_LO))
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = lm.init_cast_params(cfg, gen)   # matrices bf16; norms stay f32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_params = params.param_count(lm.model_defs(cfg))
    tokens, inputs = family_inputs(torch, np, layers, cfg, p, batch, seq,
                                   gen, VLM_C_LAYOUT)
    state = decode.init_decode(cfg, dec_b, max_len, dev)
    caches = [c for _, c in params.leaves(state.caches)]
    for cache in caches:
        cache.normal_(generator=gen)
    # Ragged positions; the top leaves room for every step of this phase
    # (warm-up, counted run, sync check, profile) to write a slot of its
    # own.
    state = state._replace(cache_pos=torch.randint(
        lo, max_len - DECODE_STEPS - 8, (dec_b,), generator=gen,
        device=dev, dtype=torch.int32))
    live = int(state.cache_pos.sum())
    cache_gb = sum(c.numel() * c.element_size() for c in caches) / 1e9
    step_tokens = torch.randint(0, cfg.vocab, (dec_b,), generator=gen,
                                device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    what = (f"prefill B={batch}: {cfg.enc_seq} encoder frames and {seq} "
            f"decoder tokens each" if enc else f"prefill B={batch} S={seq}")
    if vlm:
        what += (f" from embeddings (text {VLM_C_LAYOUT[0]}, a "
                 f"{VLM_C_LAYOUT[1][0]}x{VLM_C_LAYOUT[1][1]} image, text "
                 f"{VLM_C_LAYOUT[2]}) at M-RoPE positions")
    print(f"{label} C: {cfg.name} ({cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder layers" if enc else "")
          + f", bf16, {n_params / 1e9:.3f}B parameters) weights and a "
          f"{dec_b}x{max_len} cache ({cache_gb:.2f} GB"
          + (", cross caches included" if enc else "")
          + f") on the card in {time.perf_counter() - t0:.1f} s; {what}; "
          f"cache positions {int(state.cache_pos.min())}.."
          f"{int(state.cache_pos.max())} (mean {live / dec_b:.0f})",
          flush=True)

    def prefill():
        return lm.forward(p, cfg, tokens if not vlm else None, **inputs)

    def step():
        nonlocal state, step_tokens
        logits, state = decode.decode_step(p, cfg, state, step_tokens)
        step_tokens = logits.argmax(-1).to(torch.int32)
        return logits

    prefill()                           # warm-ups, outside the counted run
    step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prefill_ms, step_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        logits = prefill()
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if tuple(logits.shape) != (batch, seq, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{label} C prefill logits {tuple(logits.shape)} or not finite")
    del logits
    for _ in range(DECODE_STEPS):
        t0 = time.perf_counter()
        step_logits = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launch_counts()
    n = family_launches(cfg, 3, DECODE_STEPS)
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attention_tc=n["prefill"],
                  decode_attention=n["decode"])
    if launches != expect:
        fail(f"{label} C launch counts {launches} != {expect}")
    check_decode_layout(torch, label, cfg, n["decode"])
    if tuple(step_logits.shape) != (dec_b, cfg.vocab) or \
            not bool(torch.isfinite(step_logits).all()):
        fail(f"{label} C decode logits {tuple(step_logits.shape)} or not "
             f"finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # One step with every synchronising CUDA call an error.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    total_s = sum(step_ms) / 1e3
    prefill_tokens = batch * seq + (batch * cfg.enc_seq if enc else 0)
    print(f"{label} C: prefill: median {statistics.median(prefill_ms):.2f} "
          f"ms (runs {', '.join(f'{t:.2f}' for t in prefill_ms)}), "
          f"{prefill_tokens / statistics.median(prefill_ms) * 1e3:.1f} "
          f"tokens/s{' (encoder frames included)' if enc else ''}; decode "
          f"B={dec_b} max_len "
          f"{max_len}: median {statistics.median(step_ms):.3f} ms/step (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{dec_b * DECODE_STEPS / total_s:.1f} tokens/s over "
          f"{DECODE_STEPS} steps; launches {launches}; a step under sync "
          f"debug mode \"error\" made no synchronising call; peak device "
          f"memory {peak:.2f} GiB", flush=True)
    print(profile_window(torch, f"{cfg.name} decode B={dec_b}",
                         lambda: [step() for _ in range(4)], 4, "step",
                         names=decode_kernel(cfg)[1]), flush=True)
    return {"flash_attention_tc": launches["flash_attention_tc"],
            "decode_attention": launches["decode_attention"]}


def serve_families(torch, np, dev, kernels, lm_configs, convert, lm, decode,
                   params, layers, runs, main_launches, lm_paths) -> None:
    """``check_family`` and ``serve_family`` for each (label, arch, golden,
    B's seed, C's seed) of ``runs``, their launches added to
    ``main_launches`` (by counter) and ``lm_paths`` (by counter and
    phase)."""
    for label, arch, golden, b_seed, c_seed in runs:
        torch.cuda.empty_cache()
        for k, paths in check_family(torch, np, dev, kernels, lm_configs,
                                     convert, lm, decode, params, layers,
                                     label, arch, golden, b_seed).items():
            for path, n in paths.items():
                main_launches[k] = main_launches.get(k, 0) + n
                lm_paths.setdefault(k, {})[path] = n
        torch.cuda.empty_cache()
        for k, n in serve_family(torch, np, dev, kernels, lm_configs, lm,
                                 decode, params, layers, label, arch,
                                 c_seed).items():
            main_launches[k] = main_launches.get(k, 0) + n
            lm_paths.setdefault(k, {})[f"{label} C serving"] = n


# F4: the bf16 GEMM's gradient (layers.matmul_f32_out_grads) is held to
# JAX's arithmetic, the f32 cotangent times the bf16 operand summed in f32
# and rounded once: each entry within one bf16 ulp of it plus F4_SLACK x
# (|dy| @ |w|), the sum's magnitude (f32 summation order and the
# cotangent's two-part split show only where a sum cancels; rounding the
# cotangent to bf16 first is ~2^-9 of it).
F4_SLACK = 2.0 ** -16


def bf16_departure(torch, got, want, scale):
    """A bf16 gradient ``got`` against ``want`` (JAX's arithmetic): the
    share of entries more than one bf16 ulp of ``want`` away, and the
    largest excess over that ulp in units of ``scale`` (the entries' |dy|
    @ |w|)."""
    want, got = want.float(), got.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    diff = (got - want).abs()
    return float((diff > ulp).double().mean()), \
        float(((diff - ulp).clamp_min(0) / scale.clamp_min(1e-30)).max())


def check_matmul_grad(torch, dev, layers) -> None:
    """F4 on the card: the gradient of LM T's bf16 MLP GEMM (tokens x
    d_model 2048 @ 2048 x ffn 11008, f32 out) through
    ``layers._dot_f32``'s autograd, against JAX's arithmetic emulated in
    float64 and rounded once to bf16 (``bf16_departure``, F4_SLACK)."""
    g = torch.Generator(device=dev).manual_seed(12)
    m, k, n = T_SEQ, 2048, 11008
    x = torch.randn(m, k, generator=g, device=dev).bfloat16() \
        .requires_grad_()
    w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).bfloat16() \
        .requires_grad_()
    dy = torch.randn(m, n, generator=g, device=dev)
    layers._dot_f32(x, w).backward(dy)
    d64 = dy.double()
    wants = ((d64 @ w.detach().double().t()).bfloat16(),
             (x.detach().double().t() @ d64).bfloat16())
    scales = (dy.abs() @ w.detach().float().abs().t(),
              x.detach().float().abs().t() @ dy.abs())
    # The arithmetic before F4 was settled, for the record: the cotangent
    # rounded to bf16, then bf16 GEMMs.
    g16 = dy.bfloat16()
    before = (g16 @ w.detach().t(), x.detach().t() @ g16)
    out = []
    for name, got, old, want, scale in zip(("dx", "dw"), (x.grad, w.grad),
                                           before, wants, scales):
        share, excess = bf16_departure(torch, got, want, scale)
        if excess > F4_SLACK:
            fail(f"F4: the bf16 GEMM's {name} departs from JAX's arithmetic "
                 f"by {excess:.3g} of |dy|.|w| past one bf16 ulp (allowed "
                 f"{F4_SLACK:.3g})")
        share_old, excess_old = bf16_departure(torch, old, want, scale)
        out.append(f"{name} {100 * share:.4f}% of entries past one ulp, "
                   f"excess at most 2^{math.log2(max(excess, 2 ** -149)):.1f}"
                   f" of |dy|.|w| (the cotangent rounded first: "
                   f"{100 * share_old:.2f}%, 2^"
                   f"{math.log2(max(excess_old, 2 ** -149)):.1f})")
    print(f"F4: the bf16 GEMM's gradient at {m}x{k} @ {k}x{n} against JAX's "
          f"arithmetic (float64, rounded once): {'; '.join(out)} (allowed "
          f"one ulp + 2^-16)", flush=True)


def check_bmm_grad(torch, dev, layers, cfg, n_tokens: int) -> None:
    """F4 for the experts' batched GEMM on the card: the gradient of
    ``cfg``'s w_gate product at ``n_tokens`` tokens (E experts x the
    capacity's rows, d_model @ d_model x moe_d_ff, f32 out) through
    ``layers._bmm_f32``'s autograd (``_BmmF32Out``), against JAX's
    arithmetic emulated in float64 and rounded once to bf16, as
    ``check_matmul_grad`` holds the dense GEMM's."""
    g = torch.Generator(device=dev).manual_seed(13)
    e, c = cfg.n_experts, layers.moe_capacity(cfg, n_tokens)
    k, n = cfg.d_model, cfg.moe_d_ff
    x = torch.randn(e, c, k, generator=g, device=dev).bfloat16() \
        .requires_grad_()
    w = (torch.randn(e, k, n, generator=g, device=dev) * k ** -0.5) \
        .bfloat16().requires_grad_()
    dy = torch.randn(e, c, n, generator=g, device=dev)
    layers._bmm_f32(x, w).backward(dy)
    d64 = dy.double()
    wants = (torch.bmm(d64, w.detach().double().transpose(1, 2)).bfloat16(),
             torch.bmm(x.detach().double().transpose(1, 2), d64).bfloat16())
    scales = (torch.bmm(dy.abs(), w.detach().float().abs().transpose(1, 2)),
              torch.bmm(x.detach().float().abs().transpose(1, 2), dy.abs()))
    out = []
    for name, got, want, scale in zip(("dx", "dw"), (x.grad, w.grad), wants,
                                      scales):
        share, excess = bf16_departure(torch, got, want, scale)
        if excess > F4_SLACK:
            fail(f"F4: the experts' batched GEMM's {name} departs from JAX's "
                 f"arithmetic by {excess:.3g} of |dy|.|w| past one bf16 ulp "
                 f"(allowed {F4_SLACK:.3g})")
        out.append(f"{name} {100 * share:.4f}% of entries past one ulp, "
                   f"excess at most 2^{math.log2(max(excess, 2 ** -149)):.1f}"
                   f" of |dy|.|w|")
    print(f"F4: {cfg.name}'s expert GEMM's gradient ({e} x {c}x{k} @ "
          f"{k}x{n}, _BmmF32Out) against JAX's arithmetic (float64, rounded "
          f"once): {'; '.join(out)} (allowed one ulp + 2^-16)", flush=True)


def check_gradients_reach(torch, dev, ops, fa_ops, dec_ops) -> None:
    """F3 on the card: autograd through ``ops.flash_attention`` and
    ``ops.decode_attention`` gives q, k and v (and the caches) their
    gradients through the backward kernels (each counter up by one), the
    same as the kernels called directly. Fatal otherwise."""
    g = torch.Generator(device=dev).manual_seed(7)

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=dtype).requires_grad_()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (leaf(1, n, 333, 128, dtype=dtype) for n in (16, 2, 2))
        out = ops.flash_attention(q, k, v, True)
        do = torch.randn(out.shape, generator=g, device=dev, dtype=dtype)
        counter = "bwd_tc_launches" if fa_ops.route(dtype, 128) == "tc" \
            else "bwd_launches"
        before = getattr(fa_ops, counter)
        out.backward(do)
        if getattr(fa_ops, counter) != before + 1 or any(
                t.grad is None for t in (q, k, v)):
            fail(f"flash_attention ({dtype}): the backward kernel did not "
                 f"give q, k and v their gradients")
        want = fa_ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                          out.detach(), do, True)
        if not all(torch.equal(t.grad, w) for t, w in zip((q, k, v), want)):
            fail(f"flash_attention ({dtype}): autograd's gradients differ "
                 f"from the backward kernel's")
    q, ck, cv = leaf(4, 16, 128), leaf(4, 2, 700, 128), leaf(4, 2, 700, 128)
    pos = torch.tensor([1, 300, 700, 0], dtype=torch.int32, device=dev)
    out = ops.decode_attention(q, ck, cv, pos)
    do = torch.randn(out.shape, generator=g, device=dev, dtype=out.dtype)
    before = dec_ops.bwd_launches
    out.backward(do)
    if dec_ops.bwd_launches != before + 1 or any(
            t.grad is None for t in (q, ck, cv)):
        fail("decode_attention: the backward kernel did not give q and the "
             "caches their gradients")
    want = dec_ops.decode_attention_bwd(q.detach(), ck.detach(), cv.detach(),
                                        pos, out.detach(), do)
    if not all(torch.equal(t.grad, w) for t, w in zip((q, ck, cv), want)):
        fail("decode_attention: autograd's gradients differ from the "
             "backward kernel's")
    print("LM T: gradients reach q, k, v and the caches through the "
          "backward kernels (flash bf16 on the tensor-core route and f32 on "
          "the 3xTF32 one, decode bf16; F3)", flush=True)


def tree_close(torch, params, got, want, tol: float, what: str,
               extra: float = 0.0) -> float:
    """Every leaf of ``got`` finite and within ``tol`` of its scale (the
    leaf's largest magnitude in ``want``) plus ``extra``; returns the
    largest difference over its scale."""
    want = dict(params.leaves(want))
    worst = 0.0
    for path, g in params.leaves(got):
        w = want[path].to(g.device)
        if not w.numel():   # a stack of no layers
            if g.shape != w.shape:
                fail(f"{what} {'/'.join(path)}: shape {tuple(g.shape)}, "
                     f"want {tuple(w.shape)}")
            continue
        scale = float(w.abs().max())
        diff = float((g.float() - w.float()).abs().max())
        if not bool(torch.isfinite(g).all()) or \
                diff > tol * scale + extra:
            fail(f"{what} {'/'.join(path)}: off by {diff} (scale {scale}, "
                 f"tolerance {tol} of it + {extra})")
        worst = max(worst, diff / max(scale, 1e-30))
    return worst


def grads_of(torch, params, lm, cfg, p, batch):
    """(loss, gradient tree) of ``lm.loss_fn`` at ``p``; a leaf the loss
    does not reach (a stack of no layers) gets zeros, as in the train
    step."""
    req = params.tree_map(lambda t: t.detach().requires_grad_(), p)
    loss = lm.loss_fn(req, cfg, batch)
    g = torch.autograd.grad(loss, [t for _, t in params.leaves(req)],
                            allow_unused=True, materialize_grads=True)
    return loss.detach(), params.from_leaves(zip(
        (path for path, _ in params.leaves(req)), g))


def steps_agree(torch, params, optimizer, trainstep, cfg, p_card, p_cpu,
                batch_pair, accums, what: str) -> None:
    """A ``make_train_step`` step for each grad_accum of ``accums`` from
    the same f32 weights on the card and on the CPU (``batch_pair(b)``
    gives the two copies of a batch of b sequences: LM_B_BATCH a step,
    twice that at grad_accum 2), held to each other: the loss within
    1e-4, both moments within 1e-4 of their scale and the parameters
    within 1e-4 of theirs plus the sum of the steps' learning rates
    (AdamW's normalised move of an entry whose gradient is near eps)."""
    ocfg = optimizer.AdamWConfig()
    steps = {w: (p, optimizer.init(p)) for w, p in (("card", p_card),
                                                    ("cpu", p_cpu))}
    lr_sum = 0.0
    for i, accum in enumerate(accums):
        c = dataclasses.replace(cfg, grad_accum=accum)
        card_batch, cpu_batch = batch_pair(2 * LM_B_BATCH if accum > 1
                                           else LM_B_BATCH)
        out = {}
        for where, batch in (("card", card_batch), ("cpu", cpu_batch)):
            p, state = steps[where]
            p, state, m = trainstep.make_train_step(c, ocfg)(p, state, batch)
            steps[where] = (p, state)
            out[where] = m
        lr_sum += float(out["cpu"]["lr"])
        lc, lp = float(out["card"]["loss"]), float(out["cpu"]["loss"])
        if abs(lc - lp) > 1e-4 * abs(lp):
            fail(f"{what} step {i + 1} (grad_accum {accum}): loss {lc} on "
                 f"the card vs {lp} on the CPU")
        for name in ("m", "v"):
            tree_close(torch, params, getattr(steps["card"][1], name),
                       getattr(steps["cpu"][1], name), 1e-4,
                       f"{what} step {i + 1} {name}")
        worst = tree_close(torch, params, steps["card"][0], steps["cpu"][0],
                           1e-4, f"{what} step {i + 1} params", lr_sum)
        print(f"{what}: step {i + 1} (grad_accum {accum}): loss {lc:.6f} "
              f"(CPU {lp:.6f}), grad norm {float(out['card']['grad_norm']):.6f}"
              f" (CPU {float(out['cpu']['grad_norm']):.6f}); moments within "
              f"1e-4 of their scale, parameters within {worst:.3g} of theirs",
              flush=True)


def train_lm(torch, dev, kernels, lm_configs, lm, params, optimizer,
             trainstep, loop):
    """LM T: training qwen2.5-3B on the card. Correctness: full width with
    2 layers in f32 (LM B's rescaled attention weights), loss and every
    gradient, a train step and one with grad_accum 2, the card against
    the CPU within 1e-4 of the values' scale (the parameters also within
    the sum of the steps' learning rates: AdamW's normalised move of an
    entry whose gradient is near eps). Timed: 36 layers in bf16 over f32
    masters, remat "full", B=T_BATCH, S=T_SEQ, a warm-up then T_STEPS
    steps, launches checked. Then ``fit`` at the SMOKE config cut and
    resumed. Returns K5's and K6's launch counts (both directions) over
    the timed steps, and the ``tf32x3`` gradient's (``flash_attention_bwd``)
    over the f32 correctness steps (one a layer a backward pass: checked)
    and ``fit`` (at least one)."""
    f32 = torch.float32
    cpu = torch.device("cpu")
    # -- correctness: 2 layers at full width, f32, card vs CPU ---------------
    cfg = dataclasses.replace(lm_configs.get(LM_ARCH), n_layers=LM_B_LAYERS,
                              dtype=f32)
    p_card = params.init_params(lm.model_defs(cfg),
                                torch.Generator(device=dev).manual_seed(4),
                                dev)
    rescale_attention(p_card["blocks"], cfg)   # as LM B
    p_cpu = params.tree_map(lambda t: t.to(cpu, copy=True), p_card)
    gen = torch.Generator().manual_seed(5)

    def batch_pair(b):
        host = {k: torch.randint(0, cfg.vocab, (b, LM_B_S), generator=gen,
                                 dtype=torch.int32)
                for k in ("tokens", "labels")}
        return {k: v.to(dev) for k, v in host.items()}, host
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    card_batch, cpu_batch = batch_pair(LM_B_BATCH)
    grads = {}
    for where, p, batch in (("card", p_card, card_batch),
                            ("cpu", p_cpu, cpu_batch)):
        loss, g = grads_of(torch, params, lm, cfg, p, batch)
        grads[where] = (float(loss), g)
    if abs(grads["card"][0] - grads["cpu"][0]) > 1e-4 * abs(grads["cpu"][0]):
        fail(f"LM T: loss on the card {grads['card'][0]} vs the CPU "
             f"{grads['cpu'][0]}")
    worst = tree_close(torch, params, grads["card"][1], grads["cpu"][1],
                       1e-4, "LM T gradient")
    print(f"LM T: {cfg.name} x{LM_B_LAYERS} layers f32 B={LM_B_BATCH} "
          f"S={LM_B_S}: loss {grads['card'][0]:.6f} (CPU "
          f"{grads['cpu'][0]:.6f}), every gradient within {worst:.3g} of "
          f"its scale of the CPU's (tolerance 1e-4)", flush=True)
    del grads
    steps_agree(torch, params, optimizer, trainstep, cfg, p_card, p_cpu,
                batch_pair, (1, 2), "LM T")
    f32_bwd = kernels.launch_counts()["flash_attention_bwd"]
    # A backward pass for the gradient, one for the first step, two for
    # the grad_accum 2 step: one launch a layer each.
    if f32_bwd != LM_B_LAYERS * 4:
        fail(f"LM T: the f32 steps launched the tf32x3 gradient {f32_bwd} "
             f"times, not {LM_B_LAYERS * 4}")
    print(f"LM T: correctness on the card vs the CPU in "
          f"{time.perf_counter() - t0:.1f} s; flash_attention_bwd (tf32x3) "
          f"launched {f32_bwd} times", flush=True)
    del p_card, p_cpu
    torch.cuda.empty_cache()

    # -- timed: 36 layers, bf16 compute over f32 masters ---------------------
    cfg = lm_configs.get(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(6)
    t0 = time.perf_counter()
    p = params.init_params(lm.model_defs(cfg), gen, dev)
    state = optimizer.init(p)
    ocfg = optimizer.AdamWConfig()
    step = trainstep.make_train_step(cfg, ocfg)
    batches = [{k: torch.randint(0, cfg.vocab, (T_BATCH, T_SEQ),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
                for k in ("tokens", "labels")} for _ in range(T_STEPS + 3)]
    torch.cuda.synchronize()
    print(f"LM T: {cfg.name} ({cfg.n_layers} layers, {str(cfg.dtype)[6:]} "
          f"over f32 masters, remat {cfg.remat}) weights and AdamW state on "
          f"the card in {time.perf_counter() - t0:.1f} s", flush=True)
    p, state, m = step(p, state, batches[-1])        # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for batch in batches[:T_STEPS]:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        p, state, m = step(p, state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attention_tc=2 * cfg.n_layers * T_STEPS,
                  flash_attention_bwd_tc=cfg.n_layers * T_STEPS)
    if launches != expect:
        fail(f"LM T launch counts {launches} != {expect}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"LM T losses {losses} not finite")
    med = statistics.median(ms)
    print(f"LM T: train step B={T_BATCH} S={T_SEQ}: median {med:.2f} ms "
          f"(steps {', '.join(f'{x:.2f}' for x in ms)}), "
          f"{T_BATCH * T_SEQ / med * 1e3:.1f} tokens/s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches a step "
          f"{ {k: v // T_STEPS for k, v in launches.items() if v} }; peak "
          f"device memory {peak:.2f} GiB", flush=True)
    it = iter(batches[T_STEPS:T_STEPS + 2])

    def two_steps():
        nonlocal p, state
        for batch in it:
            p, state, _ = step(p, state, batch)
    print(profile_window(torch, f"{cfg.name} train step B={T_BATCH} "
                         f"S={T_SEQ}", two_steps, 2, "step",
                         names=T_PROFILED), flush=True)
    del p, state, batches, it
    torch.cuda.empty_cache()

    # -- fit, cut and resumed ------------------------------------------------
    cfg = dataclasses.replace(lm_configs.get_smoke(LM_ARCH), dtype=f32)
    kw = dict(global_batch=4, seq_len=64, ckpt_every=2, seed=1,
              log_every=100, torch_device=dev, ocfg=optimizer.AdamWConfig(
                  lr=1e-3, warmup_steps=2, total_steps=6))
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        uncut = loop.fit(cfg, 6, ckpt_dir=f"{tmp}/a", **kw)
        first = loop.fit(cfg, 4, ckpt_dir=f"{tmp}/b", **kw)
        resumed = loop.fit(cfg, 6, ckpt_dir=f"{tmp}/b", **kw)
    if resumed.restored_from != 4 or first.losses != uncut.losses[:4] or \
            resumed.losses != uncut.losses[4:]:
        fail(f"LM T fit: cut at 4 and resumed from {resumed.restored_from}: "
             f"{first.losses} + {resumed.losses} != {uncut.losses}")
    fit_bwd = kernels.launch_counts()["flash_attention_bwd"]
    if not fit_bwd:
        fail("LM T fit: the f32 steps never launched the tf32x3 gradient")
    print(f"LM T: fit {cfg.name} on the card, 6 steps, checkpoints every 2:"
          f" cut after 4 and resumed from step {resumed.restored_from}, the "
          f"losses equal the uncut run's bit for bit ({', '.join(f'{x:.5f}' for x in uncut.losses)}; "
          f"{time.perf_counter() - t0:.1f} s); flash_attention_bwd "
          f"(tf32x3) launched {fit_bwd} times", flush=True)
    out = {k: launches[k] for k in ("flash_attention_tc",
                                    "flash_attention_bwd_tc",
                                    "decode_attention", "decode_attention_bwd")}
    out["flash_attention_bwd"] = f32_bwd + fit_bwd
    return out


def rescale_stacks(cfg, p, lm) -> None:
    """Every attention stack of ``p`` rescaled in place (``rescale_mla``
    for MLA, ``rescale_attention`` otherwise, an encoder-decoder's cross
    attention too): scores of order 1, a well-conditioned f32 gradient
    (see ``rescale_attention``)."""
    for key, _ in lm.stacks(cfg):
        if cfg.attn_kind == "mla":
            rescale_mla(p[key])
        else:
            rescale_attention(p[key], cfg)


def same_routes(torch, label: str, card_routes, cpu_routes, k: int) -> str:
    """Fail unless the card's recorded MoE calls routed every token to the
    CPU's experts; returns a line with the smallest top-k gaps."""
    if len(card_routes) != len(cpu_routes):
        fail(f"{label}: {len(card_routes)} MoE calls on the card, "
             f"{len(cpu_routes)} on the CPU")
    for i, ((_, got), (_, want)) in enumerate(zip(card_routes, cpu_routes)):
        if not torch.equal(got.cpu(), want):
            fail(f"{label}: MoE call {i} routed "
                 f"{int((got.cpu() != want).any(-1).sum())} tokens to other "
                 f"experts on the card than on the CPU")
    if not cpu_routes:
        return "no MoE layer"
    return (f"routing of {sum(w.shape[0] for _, w in cpu_routes)} tokens "
            f"over {len(cpu_routes)} MoE calls equal; smallest gap between "
            f"the k-th and (k+1)-th router probability "
            f"{route_gap(torch, card_routes, k):.3g} (card), "
            f"{route_gap(torch, cpu_routes, k):.3g} (CPU)")


def train_smoke(torch, dev, kernels, lm_configs, lm, params, optimizer,
                trainstep, label: str, arch: str, seed: int):
    """MLA T at SMOKE size (deepseek-v2's qk 24 / value 16: K5's ``tf32x3``
    gradient at (24, 16)): in f32 (seeded weights, attention rescaled) the
    loss, every gradient and three train steps (grad_accum 1, 1, 2) on the
    card against the CPU within 1e-4 of the values' scale; in bf16 (the
    SMOKE config's own dtype) the loss and the logits within 3e-2 of the
    CPU's (``mla_smoke_bf16``'s tolerance) and every gradient finite.
    Returns the ``tf32x3`` gradient's launches: {"<label> T SMOKE f32": n,
    "<label> T SMOKE bf16": n}, checked (one a layer a backward pass)."""
    cpu = torch.device("cpu")
    out = {}
    t0 = time.perf_counter()
    smoke = lm_configs.get_smoke(arch)
    for dtype in (torch.float32, torch.bfloat16):
        kernels.reset_launch_counts()
        cfg = dataclasses.replace(smoke, dtype=dtype)
        p_card = params.init_params(
            lm.model_defs(cfg), torch.Generator(device=dev).manual_seed(seed),
            dev)
        rescale_stacks(cfg, p_card, lm)
        p_cpu = params.tree_map(lambda t: t.to(cpu, copy=True), p_card)
        gen = torch.Generator().manual_seed(seed + 1)

        def batch_pair(b):
            host = {k: torch.randint(0, cfg.vocab, (b, 64), generator=gen,
                                     dtype=torch.int32)
                    for k in ("tokens", "labels")}
            return {k: v.to(dev) for k, v in host.items()}, host
        card_batch, cpu_batch = batch_pair(LM_B_BATCH)
        loss_c, g_c = grads_of(torch, params, lm, cfg, p_card, card_batch)
        loss_p, g_p = grads_of(torch, params, lm, cfg, p_cpu, cpu_batch)
        name = f"{label} T SMOKE " + ("bf16" if dtype == torch.bfloat16
                                      else "f32")
        if dtype == torch.bfloat16:
            with torch.no_grad():
                lc = lm.forward(p_card, cfg, card_batch["tokens"]).cpu()
                lp = lm.forward(p_cpu, cfg, cpu_batch["tokens"])
            err = float((lc - lp).abs().max())
            tol = 3e-2 * max(1.0, float(lp.abs().max()))
            if abs(float(loss_c) - float(loss_p)) > 3e-2 * max(
                    1.0, abs(float(loss_p))) or err > tol or not all(
                    bool(torch.isfinite(g).all())
                    for _, g in params.leaves(g_c)):
                fail(f"{name}: loss {float(loss_c)} (CPU {float(loss_p)}), "
                     f"logits off by {err} (tolerance {tol:.3g}), or a "
                     f"gradient not finite")
            launches = kernels.launch_counts()
            print(f"{name}: {cfg.name} bf16 B={LM_B_BATCH} S=64: loss "
                  f"{float(loss_c):.5f} (CPU {float(loss_p):.5f}), logits "
                  f"within {err:.3g} of the CPU's (tolerance 3e-2 of their "
                  f"scale), every gradient finite; launches {launches}",
                  flush=True)
            # One backward pass, and the logits' forward (no gradient).
            passes, forwards = 1, cfg.n_layers
        else:
            if abs(float(loss_c) - float(loss_p)) > 1e-4 * abs(float(loss_p)):
                fail(f"{name}: loss on the card {float(loss_c)} vs the CPU "
                     f"{float(loss_p)}")
            worst = tree_close(torch, params, g_c, g_p, 1e-4,
                               f"{name} gradient")
            print(f"{name}: {cfg.name} f32 B={LM_B_BATCH} S=64: loss "
                  f"{float(loss_c):.6f} (CPU {float(loss_p):.6f}), every "
                  f"gradient within {worst:.3g} of its scale of the CPU's",
                  flush=True)
            accums = (1, 1, 2)
            steps_agree(torch, params, optimizer, trainstep, cfg, p_card,
                        p_cpu, batch_pair, accums, name)
            launches = kernels.launch_counts()
            passes, forwards = 1 + sum(accums), 0
        expect = dict.fromkeys(launches, 0)
        expect.update(flash_attention=(1 + (cfg.remat == "full"))
                      * cfg.n_layers * passes + forwards,
                      flash_attention_bwd=cfg.n_layers * passes)
        if launches != expect:
            fail(f"{name} launch counts {launches} != {expect}")
        out[name] = launches["flash_attention_bwd"]
    print(f"{label} T SMOKE: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def train_moe(torch, dev, kernels, lm_configs, lm, params, optimizer,
              trainstep, layers, label: str, arch: str, check_layers: int,
              layers_timed: int, seed: int, accums=(1, 1, 1, 2),
              adamw: bool = True):
    """MoE T / MLA T: training a moe architecture on the card.
    Correctness: full width at ``check_layers`` layers in f32 (attention
    rescaled, ``rescale_stacks``) at LM B's shape: the loss and every
    gradient, then a ``make_train_step`` step for each of ``accums`` (its
    grad_accum), the card against the CPU within 1e-4 of the values'
    scale (the parameters also within the steps' learning rates), the
    routing equal. Timed: ``layers_timed`` layers in bf16 over f32 masters,
    remat "full", B=T_BATCH, S=T_SEQ, a warm-up then TM_STEPS train steps
    (``adamw``) or loss-and-gradient passes; the warm-up's recomputed
    forward (remat) routes every token as its first forward did; launches
    checked, expert loads and drops, a profile. Returns the attention
    kernels' launches over the counted runs: the f32 correctness passes
    (the ``tf32x3`` gradient) and the timed ones (the ``tc`` routes)."""
    f32 = torch.float32
    cpu = torch.device("cpu")
    out = {}
    # -- correctness: full width, f32, card vs CPU ---------------------------
    cfg = dataclasses.replace(lm_configs.get(arch), n_layers=check_layers,
                              dtype=f32)
    p_card = params.init_params(lm.model_defs(cfg),
                                torch.Generator(device=dev).manual_seed(seed),
                                dev)
    rescale_stacks(cfg, p_card, lm)
    p_cpu = params.tree_map(lambda t: t.to(cpu, copy=True), p_card)
    n_params = params.param_count(lm.model_defs(cfg))
    gen = torch.Generator().manual_seed(seed + 1)

    def batch_pair(b):
        host = {k: torch.randint(0, cfg.vocab, (b, LM_B_S), generator=gen,
                                 dtype=torch.int32)
                for k in ("tokens", "labels")}
        return {k: v.to(dev) for k, v in host.items()}, host
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    card_batch, cpu_batch = batch_pair(LM_B_BATCH)
    (loss_c, g_c), routes_c = recorded_routes(layers, lambda: grads_of(
        torch, params, lm, cfg, p_card, card_batch))
    (loss_p, g_p), routes_p = recorded_routes(layers, lambda: grads_of(
        torch, params, lm, cfg, p_cpu, cpu_batch))
    routing = same_routes(torch, f"{label} T", routes_c, routes_p, cfg.top_k)
    if abs(float(loss_c) - float(loss_p)) > 1e-4 * abs(float(loss_p)):
        fail(f"{label} T: loss on the card {float(loss_c)} vs the CPU "
             f"{float(loss_p)}")
    worst = tree_close(torch, params, g_c, g_p, 1e-4, f"{label} T gradient")
    print(f"{label} T: {cfg.name} x{check_layers} layers ({cfg.first_dense}"
          f" dense + {check_layers - cfg.first_dense} MoE, "
          f"{n_params / 1e9:.3f}B parameters) f32 B={LM_B_BATCH} S={LM_B_S}: "
          f"loss {float(loss_c):.6f} (CPU {float(loss_p):.6f}), every "
          f"gradient within {worst:.3g} of its scale of the CPU's "
          f"(tolerance 1e-4); {routing}", flush=True)
    del g_c, g_p, routes_c, routes_p
    steps_agree(torch, params, optimizer, trainstep, cfg, p_card, p_cpu,
                batch_pair, accums, f"{label} T")
    launches = kernels.launch_counts()
    # A backward pass for the gradient, one a step, two a grad_accum 2
    # step: one tf32x3 gradient launch a layer each, and the forward's
    # (twice under remat: its recompute).
    passes = 1 + sum(accums)
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attention=(1 + (cfg.remat == "full")) * check_layers
                  * passes, flash_attention_bwd=check_layers * passes)
    if launches != expect:
        fail(f"{label} T: the f32 correctness passes' launch counts "
             f"{launches} != {expect}")
    out["flash_attention_bwd"] = launches["flash_attention_bwd"]
    print(f"{label} T: correctness on the card vs the CPU in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    del p_card, p_cpu
    torch.cuda.empty_cache()

    # -- timed: bf16 over f32 masters, remat full -----------------------------
    cfg = dataclasses.replace(lm_configs.get(arch), n_layers=layers_timed,
                              grad_accum=1)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    t0 = time.perf_counter()
    p = params.init_params(lm.model_defs(cfg), gen, dev)
    rescale_stacks(cfg, p, lm)
    n_params = params.param_count(lm.model_defs(cfg))
    state = optimizer.init(p) if adamw else None
    step = trainstep.make_train_step(cfg, optimizer.AdamWConfig())
    batches = [{k: torch.randint(0, cfg.vocab, (T_BATCH, T_SEQ),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
                for k in ("tokens", "labels")} for _ in range(TM_STEPS + 3)]
    torch.cuda.synchronize()
    print(f"{label} T: {cfg.name} ({layers_timed} layers: {cfg.first_dense} "
          f"dense + {layers_timed - cfg.first_dense} MoE, "
          f"{n_params / 1e9:.3f}B parameters, {str(cfg.dtype)[6:]} over f32 "
          f"masters, remat {cfg.remat}) weights"
          + (" and AdamW state" if adamw else "") + f" on the card in "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)

    def run(batch):
        nonlocal p, state
        if adamw:
            p, state, m = step(p, state, batch)
            return m["loss"]
        loss, grads = grads_of(torch, params, lm, cfg, p, batch)
        del grads
        return loss
    # Warm-up, its routing recorded: the forward's MoE calls, then the
    # backward's recomputes (remat) in reverse layer order.
    _, routes = recorded_routes(layers, lambda: run(batches[-1]))
    torch.cuda.synchronize()
    n_moe = layers_timed - cfg.first_dense
    if len(routes) != 2 * n_moe or not all(
            torch.equal(a[1], b[1]) for a, b in
            zip(routes[:n_moe], routes[n_moe:][::-1])):
        fail(f"{label} T: the recomputed forward (remat) routed tokens "
             f"otherwise than the first ({len(routes)} MoE calls)")
    cap = layers.moe_capacity(cfg, T_BATCH * T_SEQ)
    loads = torch.stack([torch.bincount(topi.flatten(),
                                        minlength=cfg.n_experts)
                         for _, topi in routes[:n_moe]])
    dropped = int((loads - cap).clamp_min(0).sum())
    del routes
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for batch in batches[:TM_STEPS]:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = run(batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attention_tc=2 * layers_timed * TM_STEPS,
                  flash_attention_bwd_tc=layers_timed * TM_STEPS)
    if launches != expect:
        fail(f"{label} T launch counts {launches} != {expect}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label} T losses {losses} not finite")
    med = statistics.median(ms)
    what = "train step" if adamw else "loss and gradient pass"
    print(f"{label} T: {what} B={T_BATCH} S={T_SEQ}: median {med:.2f} ms "
          f"({', '.join(f'{x:.2f}' for x in ms)}), "
          f"{T_BATCH * T_SEQ / med * 1e3:.1f} tokens/s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches a {what} "
          f"{ {k: v // TM_STEPS for k, v in launches.items() if v} }; the "
          f"warm-up's routing over {n_moe} MoE layers (equal in remat's "
          f"recompute): the busiest expert takes {int(loads.max())} of "
          f"{T_BATCH * T_SEQ} tokens (capacity {cap}), the idlest "
          f"{int(loads.min())}, {dropped} of {int(loads.sum())} assignments "
          f"dropped; peak device memory {peak:.2f} GiB", flush=True)
    it = iter(batches[TM_STEPS:TM_STEPS + 2])
    print(profile_window(torch, f"{cfg.name} x{layers_timed} {what} "
                         f"B={T_BATCH} S={T_SEQ}",
                         lambda: [run(batch) for batch in it], 2,
                         "step" if adamw else "pass", names=T_PROFILED),
          flush=True)
    del p, state, batches, it
    torch.cuda.empty_cache()
    out.update(flash_attention_tc=launches["flash_attention_tc"],
               flash_attention_bwd_tc=launches["flash_attention_bwd_tc"])
    return out


def checked(what: str, check, *args):
    """Run one of ``repro_torch.testing``'s checks; a difference fails."""
    try:
        return check(*args)
    except AssertionError as e:
        fail(f"{what}: {e}")


def check_detector_golden(testing):
    """Det A: the small PointPillars config on the card against
    ``tests/goldens/det3d_smoke.npz`` (written by the JAX package) by the
    check the CPU test runs (``repro_torch.testing.check_golden``):
    forward, loss, every gradient, detect and three AdamW steps, at the CPU
    parity tests' tolerances; an element whose gradient lay within the
    gradient tolerance of 0 at some step is held to AdamW's step bound, and
    such elements must stay under 1%."""
    res = checked("Det A", testing.check_golden, DET_GOLDEN, "cuda")
    cfg = res["cfg"]
    print(f"Det A: PointPillars {cfg.grid_h}x{cfg.grid_w} (feat "
          f"{cfg.feat_dim}, dims {cfg.backbone_dims}) on the card matches "
          f"{DET_GOLDEN.name}: forward, loss, {res['n_grads']} gradients, "
          f"detect ({res['n_kept']} kept) and {res['steps']} AdamW steps; "
          f"largest difference over each tensor's largest magnitude "
          + ", ".join(f"{k} {v:.3g}"
                                      for k, v in res["errs"].items())
          + f"; {res['loose']} of {res['total']} trained values at the step "
          f"bound (tolerance {testing.OUT_TOL} / {testing.GRAD_TOL})",
          flush=True)


def serve_detector(torch, dev, kernels, detector3d, params, optimizer,
                   testing, kitti):
    """Det B: the default PointPillars config at full width on the card,
    seeded random weights, kitti-urban frames at 122,880 points: detect
    over DET_FRAMES frames and DET_STEPS training steps (loss, backward,
    AdamW), K4's launch counts checked; a profile of 4 detect calls; then
    DET_CPU_FRAMES frames on the CPU against the card. Returns K4's launch
    counts over the counted run."""
    cfg = detector3d.PillarConfig()
    ocfg = optimizer.AdamWConfig()
    p0 = params.init_params(detector3d.detector_defs(cfg),
                            torch.Generator(device=dev).manual_seed(4), dev)
    frames = [(torch.from_numpy(pts).to(dev),
               torch.ones(len(pts), dtype=torch.bool, device=dev),
               torch.from_numpy(gtb).to(dev), torch.from_numpy(gtv).to(dev))
              for pts, gtb, gtv, _ in kitti]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def train_step(p, state, frame):
        loss, _, grads = testing.loss_grads(p, cfg, *frame)
        p, state, metrics = optimizer.update(ocfg, grads, state, p)
        return p, state, loss

    detector3d.detect(p0, cfg, *frames[0][:2])         # warm-ups
    train_step(p0, optimizer.init(p0), frames[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    det_ms = []
    for fr in frames:
        t0 = time.perf_counter()
        boxes, keep = detector3d.detect(p0, cfg, fr[0], fr[1])
        torch.cuda.synchronize()
        det_ms.append((time.perf_counter() - t0) * 1e3)
    p, state, step_ms, losses = p0, optimizer.init(p0), [], []
    for i in range(DET_STEPS):
        t0 = time.perf_counter()
        p, state, loss = train_step(p, state, frames[i % len(frames)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = kernels.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(pillar_scatter=DET_FRAMES + DET_STEPS,
                  pillar_scatter_bwd=DET_STEPS)
    if launches != expect:
        fail(f"Det B launch counts {launches} != {expect}")
    if tuple(boxes.shape) != (32, 7) or not bool(torch.isfinite(boxes).all()) \
            or not all(math.isfinite(x) for x in losses) or \
            not all(bool(torch.isfinite(t).all())
                    for _, t in params.leaves(p)):
        fail("Det B: detect boxes, losses or trained weights not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"Det B: PointPillars {cfg.grid_h}x{cfg.grid_w} at {cfg.pillar} m "
          f"(feat {cfg.feat_dim}, dims {cfg.backbone_dims}, "
          f"{params.param_count(detector3d.detector_defs(cfg))} parameters) "
          f"on kitti-urban x{DET_FRAMES} at {KITTI['n_points']} points: "
          f"detect median {statistics.median(det_ms):.3f} ms/frame (min "
          f"{min(det_ms):.3f}, max {max(det_ms):.3f}); {DET_STEPS} training "
          f"steps median {statistics.median(step_ms):.3f} ms/step (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}), losses "
          f"{losses[0]:.4g} -> {losses[-1]:.4g}; launches {launches}; peak "
          f"device memory {peak:.3f} GiB", flush=True)
    print(profile_window(
        torch, "detector3d detect",
        lambda: [detector3d.detect(p0, cfg, fr[0], fr[1])
                 for fr in frames[:4]], 4, "frame"), flush=True)

    # The same weights and frames on the CPU: outputs and every gradient
    # within the CPU parity tests' tolerances (float32 sums in another
    # order, as between the port and JAX); detect's kept flags equal.
    def close(got, want, tol, what):
        return checked(what, testing.close, got, want, tol, what)
    cpu = torch.device("cpu")
    p_cpu = params.tree_map(lambda t: t.to(cpu), p0)
    errs = {"forward": 0.0, "loss": 0.0, "grads": 0.0, "detect": 0.0}
    t0 = time.perf_counter()
    for i in range(DET_CPU_FRAMES):
        fr, fr_cpu = frames[i], [t.to(cpu) for t in frames[i]]
        for name, d, c in zip(("cls", "box"),
                              detector3d.forward(p0, cfg, fr[0], fr[1]),
                              detector3d.forward(p_cpu, cfg, *fr_cpu[:2])):
            errs["forward"] = max(errs["forward"], close(
                d, c, testing.OUT_TOL, f"Det B frame {i} {name}"))
        loss_d, _, grads_d = testing.loss_grads(p0, cfg, *fr)
        loss_c, _, grads_c = testing.loss_grads(p_cpu, cfg, *fr_cpu)
        errs["loss"] = max(errs["loss"], close(
            loss_d, loss_c, testing.OUT_TOL, f"Det B frame {i} loss"))
        gc = dict(params.leaves(grads_c))
        for path, g in params.leaves(grads_d):
            errs["grads"] = max(errs["grads"], close(
                g, gc[path], testing.GRAD_TOL,
                f"Det B frame {i} grad {'/'.join(path)}"))
        (bd, kd), (bc, kc) = (detector3d.detect(p0, cfg, fr[0], fr[1]),
                              detector3d.detect(p_cpu, cfg, *fr_cpu[:2]))
        if not torch.equal(kd.cpu(), kc):
            fail(f"Det B frame {i}: detect's kept flags differ from the CPU")
        errs["detect"] = max(errs["detect"], close(
            bd, bc, testing.OUT_TOL, f"Det B frame {i} detect boxes"))
    print(f"Det B: {DET_CPU_FRAMES} frames on the CPU "
          f"({time.perf_counter() - t0:.1f} s) match the card: largest "
          f"difference over each tensor's largest magnitude "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tolerance {testing.OUT_TOL} / {testing.GRAD_TOL})",
          flush=True)
    return {k: launches[k] for k in ("pillar_scatter", "pillar_scatter_bwd")}


def serve_fleet(torch, api, kernels, name: str, overrides, frames: int,
                cpu_frames: int, profile: bool):
    """One fleet run on the card through ``api.Session`` (the orchestrated
    ``FleetEngine``) after a warm-up, its launches checked per fleet frame
    (K1's labels instance 1, K2 2 (the anchor and the transform branch),
    K3 1, every other kernel 0), then held to the port's CPU run of the
    same preset (its first ``cpu_frames`` frames): kinds exact, floats
    within the golden tolerance. Returns the run's launch counts and
    numbers; prints wall ms per fleet frame and per stream-frame (median),
    the share of it spent copying the frame's inputs to the card, peak
    device memory and, with ``profile``, a torch.profiler window."""
    scn = api.scenario(name, **overrides)
    s_n = scn.n_streams
    # Warm-up (allocator, cuSOLVER) outside the timed run.
    api.Session(scn, torch_device="cuda").run(FLEET_WARMUP)
    session = api.Session(scn, torch_device="cuda")
    # The tapes (the streams' frames, rendered on the host) are set-up:
    # recorded before the timed run.
    t0 = time.perf_counter()
    session.engine._stacked(frames)
    record_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(point_proj_labels=frames, iou2d=2 * frames,
                  ransac_score=frames, auction=2 * frames)
    if launches != expect:
        fail(f"fleet {name}: launch counts {launches} != {expect} "
             f"(1 labels, 2 iou2d, 1 ransac_score, 2 auction a fleet "
             f"frame)")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    eng = session.engine
    frame_ms = statistics.median(eng.frame_wall_s) * 1e3
    input_ms = statistics.median(eng.input_wall_s) * 1e3
    kinds = [k for s in range(s_n) for k in report.kinds(s)]
    counts = {k: kinds.count(k) for k in ("anchor", "test", "transform")}
    rows = csv_rows(report.to_csv())
    if not all(math.isfinite(float(r[k])) for r in rows for k in FLOAT_COLS):
        fail(f"fleet {name}: non-finite values in the card's report")
    print(f"fleet {name}: {s_n} streams x {frames} frames on the card in "
          f"{wall:.2f} s (tapes recorded beforehand in {record_s:.1f} s); "
          f"median wall {frame_ms:.2f} ms a fleet frame, "
          f"{frame_ms / s_n:.3f} ms a stream-frame, of which inputs to the "
          f"card {input_ms:.2f} ms a fleet frame; peak device memory "
          f"{peak_gib:.3f} GiB; kinds {counts}; launches {launches}; mean "
          f"F1 {report.mean_f1:.4f}", flush=True)
    line = None
    if profile:
        prof = api.Session(scn, torch_device="cuda")
        prof.engine._stacked(FLEET_PROFILE_FRAMES)
        line = profile_window(
            torch, f"fleet {name}", lambda: prof.run(FLEET_PROFILE_FRAMES),
            FLEET_PROFILE_FRAMES, "fleet frame")
        print(line, flush=True)
    t0 = time.perf_counter()
    cpu = api.Session(scn, torch_device="cpu").run(cpu_frames)
    compare_rows([r for r in rows if int(r["frame"]) < cpu_frames],
                 csv_rows(cpu.to_csv()), f"fleet {name} card vs CPU")
    print(f"fleet {name} x{cpu_frames} on the CPU: "
          f"{time.perf_counter() - t0:.2f} s; the card's first {cpu_frames} "
          f"frames of every stream match it", flush=True)
    return launches, dict(
        name=name, streams=s_n, frames=frames, cpu_frames=cpu_frames,
        wall_s=wall, frame_ms=frame_ms, stream_frame_ms=frame_ms / s_n,
        input_ms=input_ms, peak_gib=peak_gib, kinds=counts,
        profile=line)


# The kernels of one captured scan frame: K1's labels instance, K2 and the
# auction in each branch (anchor and transform), K3.
SCAN_FRAME_LAUNCHES = dict(point_proj_labels=1, iou2d=2, ransac_score=1,
                           auction=2)
# The kernels' names as the profiler shows them.
SCAN_KERNEL_NAMES = dict(point_proj_labels="point_proj_kernel",
                         iou2d="iou2d_kernel",
                         ransac_score="ransac_score_kernel",
                         auction="auction_kernel")
SCAN_GOLDEN = ROOT / "tests" / "goldens" / "fleet-256-congested-scan.csv"
SCAN_GOLDEN_FRAMES = 4


def replay_profile(torch, run, n: int):
    """A torch.profiler window over ``run()`` (``n`` fleet frames of graph
    replays): the device busy share, device ops a fleet frame, and the
    launches of each scan kernel by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    counts = {k: sum(e.count for e in dev if name in e.key)
              for k, name in SCAN_KERNEL_NAMES.items()}
    top = sorted(dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:4]
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                busy_share=busy_us / wall_us if busy_us else None,
                device_ops_per_frame=sum(e.count for e in dev) / n,
                kernel_counts=counts,
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                     for e in top])


def serve_scan(torch, api, kernels, report_from_packed, name: str,
               overrides, frames: int, cpu_frames: int):
    """One fleet run in scan mode on the card through ``api.Session``
    (``run(scan=True)``: the tape copied to the card once, one frame of
    the body captured in a CUDA graph, replayed a frame under sync debug
    mode "error", one fetch) after a warm-up. Checks the captured frame's
    launches (SCAN_FRAME_LAUNCHES) and the counters (the warm-up's call of
    the body and the capture), replays of a second capture against the
    same body run eagerly on the card (bit for bit) and against the run's
    report, a profiled replay window (each kernel launched its captured
    count a frame), and the card's rows against the port's CPU scan of
    the same preset (its first ``cpu_frames`` frames): kinds exact, floats
    within the golden tolerance. Returns the counters and the numbers."""
    scn = api.scenario(name, **overrides)
    s_n = scn.n_streams
    api.Session(scn, torch_device="cuda").run(FLEET_WARMUP, scan=True)
    session = api.Session(scn, torch_device="cuda")
    eng = session.engine
    t0 = time.perf_counter()
    eng._stacked(frames)
    record_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(frames, scan=True)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    scan = eng._scan_fn()
    expect = dict.fromkeys(launches, 0)
    expect.update(SCAN_FRAME_LAUNCHES)
    if scan.captured_launches != expect:
        fail(f"scan {name}: captured launches {scan.captured_launches} != "
             f"{expect}")
    if launches != {k: 2 * v for k, v in expect.items()}:
        fail(f"scan {name}: counted launches {launches} != twice the "
             f"captured frame's (warm-up and capture)")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    timing = dict(eng.scan_timing)
    frame_ms = timing["replay_s"] / frames * 1e3

    stacked = eng._scan_inputs(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, eager = scan.run_eager(eng._init_state(), stacked, frames)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / frames * 1e3
    graph = scan.capture(eng._init_state(), stacked, frames)
    _, replayed = graph.replay(stacked)
    if not torch.equal(replayed, eager):
        fail(f"scan {name}: graph replays differ from the eager body on "
             f"the card")
    again = report_from_packed(replayed.cpu().numpy().transpose(1, 0, 2))
    for col in ("kind", "latency_s", "onboard_s", "f1", "precision",
                "recall"):
        if not (getattr(again, col) == getattr(report, col)).all():
            fail(f"scan {name}: a second capture's {col} differs from the "
                 f"run's")
    prof = replay_profile(torch, lambda: graph.replay(stacked), frames)
    want_counts = {k: v * frames for k, v in SCAN_FRAME_LAUNCHES.items()}
    if prof["busy_ms"] and prof["kernel_counts"] != want_counts:
        fail(f"scan {name}: profiled kernel launches "
             f"{prof['kernel_counts']} != {want_counts}")
    del graph, eager, replayed
    kinds = [k for s in range(s_n) for k in report.kinds(s)]
    counts = {k: kinds.count(k) for k in ("anchor", "test", "transform")}
    rows = csv_rows(report.to_csv())
    if not all(math.isfinite(float(r[k])) for r in rows for k in FLOAT_COLS):
        fail(f"scan {name}: non-finite values in the card's report")
    print(f"scan {name}: {s_n} streams x {frames} frames on the card in "
          f"{wall:.3f} s (tapes recorded beforehand in {record_s:.1f} s): "
          f"tape to the card {timing['tape_s'] * 1e3:.2f} ms, warm-up "
          f"{timing['warmup_s'] * 1e3:.1f} ms, capture "
          f"{timing['capture_s'] * 1e3:.1f} ms, replays and the fetch "
          f"{timing['replay_s'] * 1e3:.2f} ms: {frame_ms:.3f} ms a fleet "
          f"frame, {frame_ms / s_n:.4f} ms a stream-frame (the same body "
          f"eagerly on the card {eager_ms:.2f} ms a fleet frame); peak "
          f"device memory {peak_gib:.3f} GiB; kinds {counts}; captured "
          f"launches a frame {SCAN_FRAME_LAUNCHES}; replays equal the "
          f"eager body bit for bit; mean F1 {report.mean_f1:.4f}",
          flush=True)
    if prof["busy_ms"]:
        print(f"profile scan {name} x{frames} fleet frames of replays: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f}"
              f" ms ({100 * prof['busy_share']:.1f}% of wall), "
              f"{prof['device_ops_per_frame']:.0f} device ops/fleet frame; "
              f"kernels {prof['kernel_counts']}; top: {prof['top']}",
              flush=True)
    else:
        print(f"profile scan {name}: no device time in the trace (not "
              f"measured)", flush=True)
    t0 = time.perf_counter()
    cpu = api.Session(scn, torch_device="cpu").run(cpu_frames, scan=True)
    compare_rows([r for r in rows if int(r["frame"]) < cpu_frames],
                 csv_rows(cpu.to_csv()), f"scan {name} card vs CPU")
    print(f"scan {name} x{cpu_frames} on the CPU: "
          f"{time.perf_counter() - t0:.2f} s; the card's first {cpu_frames} "
          f"frames of every stream match it", flush=True)
    return launches, dict(
        name=name, streams=s_n, frames=frames, cpu_frames=cpu_frames,
        wall_s=wall, frame_ms=frame_ms, stream_frame_ms=frame_ms / s_n,
        eager_body_frame_ms=eager_ms, tape_ms=timing["tape_s"] * 1e3,
        warmup_ms=timing["warmup_s"] * 1e3,
        capture_ms=timing["capture_s"] * 1e3, peak_gib=peak_gib,
        kinds=counts, captured_launches=SCAN_FRAME_LAUNCHES,
        replayed_launches={k: v * frames
                           for k, v in SCAN_FRAME_LAUNCHES.items()},
        profile=prof)


def scan_golden(torch, api):
    """``fleet-256-congested`` in scan mode on the card against
    ``tests/goldens/fleet-256-congested-scan.csv``: stream, frame, kind
    and device exact, the modelled latency_s and onboard_s at the golden
    tolerance; F1, precision and recall, which drift from today's JAX
    engine (ROADMAP R1), against the port's CPU scan instead."""
    scn = api.scenario("fleet-256-congested")
    card = csv_rows(api.Session(scn, torch_device="cuda").run(
        SCAN_GOLDEN_FRAMES, scan=True).to_csv())
    gold = csv_rows(SCAN_GOLDEN.read_text())
    if len(card) != len(gold):
        fail(f"scan golden: {len(card)} rows vs {len(gold)}")
    for g, w in zip(card, gold):
        bad = [k for k in ("stream", "frame", "kind", "device")
               if g[k] != w[k]]
        bad += [k for k in ("latency_s", "onboard_s")
                if abs(float(g[k]) - float(w[k]))
                > ATOL + RTOL * abs(float(w[k]))]
        if bad:
            fail(f"scan fleet-256-congested vs {SCAN_GOLDEN.name}: {bad} "
                 f"at stream {w['stream']} frame {w['frame']}")
    cpu = api.Session(scn, torch_device="cpu").run(SCAN_GOLDEN_FRAMES,
                                                   scan=True)
    compare_rows(card, csv_rows(cpu.to_csv()),
                 "scan fleet-256-congested card vs CPU")
    print(f"scan fleet-256-congested x{SCAN_GOLDEN_FRAMES} on the card: "
          f"stream, frame, kind, device, latency_s and onboard_s match "
          f"{SCAN_GOLDEN.name} ({len(gold)} rows); every column matches "
          f"the port's CPU scan", flush=True)


def serve_wide(torch, api, kernels):
    """kitti-urban at KITTI's size with max_obj = 80 (an association of
    n = 160 persons, the auction's wide instance) on the card after a
    warm-up, its launches checked as phase 4's (the wide instance once a
    frame, the row instances never), then held to its CPU run in this
    process. Returns the run's launch counts and its median wall ms a
    frame (all frames, transform, anchor)."""
    scn = api.scenario("kitti-urban", seed=0, max_obj=WIDE_MAX_OBJ, **KITTI)
    api.Session(scn, torch_device="cuda").run(2)
    session = api.Session(scn, torch_device="cuda")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(WIDE_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    kinds = report.kinds()
    n_transform = sum(k != "anchor" for k in kinds)
    expect = dict.fromkeys(launches, 0)
    expect.update(point_proj_labels=n_transform, iou2d=WIDE_FRAMES,
                  ransac_score=n_transform, auction_wide=WIDE_FRAMES)
    if launches != expect:
        fail(f"kitti-urban max_obj={WIDE_MAX_OBJ}: launch counts {launches} "
             f"!= {expect} implied by kinds {kinds}")
    walls = session.engine.frame_wall_s
    per_kind = {k: statistics.median(w for w, kk in zip(walls, kinds)
                                     if (kk == "anchor") == (k == "anchor"))
                * 1e3 for k in ("anchor", "transform")}
    per_kind["frame"] = statistics.median(walls) * 1e3
    rows = csv_rows(report.to_csv())
    if not all(math.isfinite(float(r[k])) for r in rows for k in FLOAT_COLS):
        fail(f"kitti-urban max_obj={WIDE_MAX_OBJ}: non-finite values")
    t1 = time.perf_counter()
    cpu = api.Session(scn, torch_device="cpu").run(WIDE_FRAMES)
    compare_rows(rows, csv_rows(cpu.to_csv()),
                 f"kitti-urban max_obj={WIDE_MAX_OBJ} card vs CPU")
    print(f"serve kitti-urban max_obj={WIDE_MAX_OBJ} (auctions of n = "
          f"{2 * WIDE_MAX_OBJ}) x{WIDE_FRAMES} on the card: {wall:.2f} s, "
          f"kinds {''.join(k[0] for k in kinds)}, launches {launches}, "
          f"median wall ms/frame {per_kind['frame']:.3f} (transform "
          f"{per_kind['transform']:.3f}, anchor {per_kind['anchor']:.3f}); "
          f"the CPU run ({time.perf_counter() - t1:.2f} s) matches it",
          flush=True)
    return launches, per_kind


def count_syncs(torch, run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the number of synchronising CUDA calls it made."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def within_tol(g, w) -> bool:
    return abs(g - w) <= ATOL + RTOL * abs(w)


def compare_observed(got, want, what: str) -> None:
    """Audit rows (kind exact, floats at the golden tolerance) and the
    modelled trace lanes (streams, uplink, cloud GPUs: names and lanes
    exact, times in us and float args at the golden tolerance, 1e-5 s =
    10 us) of two observed runs."""
    g_rows, w_rows = got.obs.audit.rows, want.obs.audit.rows
    if len(g_rows) != len(w_rows) or not g_rows:
        fail(f"{what}: {len(g_rows)} audit rows vs {len(w_rows)}")
    for g, w in zip(g_rows, w_rows):
        bad = [k for k in ("stream", "frame", "policy", "device", "kind",
                           "frames_since_anchor") if g[k] != w[k]]
        bad += [k for k in ("err_ewma", "bw_mbps", "edge_cost_s",
                            "offload_cost_s") if not within_tol(g[k], w[k])]
        if bad:
            fail(f"{what}: audit row differs in {bad}: {g} vs {w}")

    def events(rep):
        return [e for e in rep.to_trace()["traceEvents"]
                if e["ph"] == "X" and e["pid"] in (1, 2, 3)]
    g_ev, w_ev = events(got), events(want)
    if len(g_ev) != len(w_ev):
        fail(f"{what}: {len(g_ev)} modelled trace events vs {len(w_ev)}")
    for g, w in zip(g_ev, w_ev):
        args_ok = g.get("args", {}).keys() == w.get("args", {}).keys() and \
            all(g["args"][k] == v if isinstance(v, str) else
                within_tol(g["args"][k], v) for k, v in w.get("args", {}).items())
        if (g["name"], g["pid"], g["tid"]) != (w["name"], w["pid"], w["tid"])\
                or abs(g["ts"] - w["ts"]) > ATOL * 1e6 + RTOL * abs(w["ts"])\
                or abs(g["dur"] - w["dur"]) > ATOL * 1e6 + RTOL * abs(
                    w["dur"]) or not args_ok:
            fail(f"{what}: trace event differs: {g} vs {w}")


def span_ms(rep, name: str, frames=None):
    """Median ms of an observed run's host span ``name`` (over ``frames``
    when given)."""
    d = [r["dur"] for r in rep.obs.measured if r["name"] == name
         and (frames is None or r.get("frame") in frames)]
    return statistics.median(d) * 1e3 if d else None


def serve_observed(torch, api, kernels):
    """The observability hooks on the card. kitti-urban at KITTI's size
    (``OBS_FRAMES`` after phase 4's warm-up) unobserved, with metrics and
    the trace, and with every switch on, twice each in the order ABC CBA,
    each run counting its synchronising CUDA calls: the observed reports
    equal the unobserved one bit for bit, metrics and the trace add no
    synchronisation (fatal), the all-on run's audit rows and modelled
    trace lanes equal its CPU run's; prints the host spans' medians (the
    transform step's enqueue, the stats fetch) beside the frame's wall ms,
    each over both runs of its kind. Then
    fleet-16-congested orchestrated with every switch on (bit for bit
    with its unobserved run) and in scan mode with metrics and the trace
    (the first run's ``fleet/scan_dispatch`` marked compiled: the graph
    capture), and scan mode's refusal of the audit. Returns the launch
    counts of the first metrics-and-trace run."""
    from repro_torch import obs as obs_lib
    scn = api.scenario("kitti-urban", seed=0, **KITTI)

    def cfg(audit):
        return api.ObsConfig(metrics=True, trace=True, audit=audit,
                             registry=obs_lib.MetricsRegistry())

    def run(obs):
        s = api.Session(scn, torch_device="cuda", obs=obs)
        return s.run(OBS_FRAMES), s.engine

    # None: unobserved; False: metrics and the trace; True: every switch.
    runs, syncs, launches = {}, {}, None
    for audit in (None, False, True, True, False, None):
        if audit is False and launches is None:
            kernels.reset_launch_counts()
        out, n_sync = count_syncs(torch, lambda: run(
            None if audit is None else cfg(audit)))
        if audit is False and launches is None:
            launches = kernels.launch_counts()
        runs.setdefault(audit, []).append(out)
        syncs.setdefault(audit, []).append(n_sync)
    off_syncs, mt_syncs, full_syncs = (syncs[k] for k in (None, False, True))
    if not min(off_syncs):
        fail("observability: no synchronising call counted in the "
             "unobserved run, so the count cannot see one")
    if max(mt_syncs) > min(off_syncs):
        fail(f"observability: metrics and the trace made {mt_syncs} "
             f"synchronising calls, the unobserved runs {off_syncs}")
    off, mt, full = (runs[k][0][0] for k in (None, False, True))
    kinds = off.kinds()
    n_transform = sum(k != "anchor" for k in kinds)
    expect = dict.fromkeys(launches, 0)
    expect.update(point_proj_labels=n_transform, iou2d=OBS_FRAMES,
                  ransac_score=n_transform, auction=OBS_FRAMES)
    if launches != expect:
        fail(f"observability: launch counts {launches} != {expect}")
    for key, what in ((None, "no switch"), (False, "metrics and trace"),
                      (True, "every switch")):
        if any(r.to_csv() != off.to_csv() for r, _ in runs[key]):
            fail(f"observability: a run with {what} on differs from the "
                 f"first unobserved run")
    cpu = api.Session(scn, torch_device="cpu", obs=cfg(True)).run(OBS_FRAMES)
    compare_observed(full, cpu, "observed kitti-urban card vs CPU")
    if not full.to_prometheus() or not full.to_audit():
        fail("observability: empty exposition or audit")
    tf = {t for t, k in enumerate(kinds) if k != "anchor"}

    def wall_ms(key):
        return statistics.median(eng.frame_wall_s[t] for _, eng in runs[key]
                                 for t in tf) * 1e3

    def spans_ms(name, frames=None):
        return statistics.median(
            r["dur"] for rep, _ in runs[False] for r in rep.obs.measured
            if r["name"] == name
            and (frames is None or r["frame"] in frames)) * 1e3
    split = dict(
        frame_ms=wall_ms(False), unobserved_frame_ms=wall_ms(None),
        all_on_frame_ms=wall_ms(True),
        transform_step_ms=spans_ms("moby/transform_step", tf),
        frame_stats_fetch_ms=spans_ms("moby/frame_stats_fetch", tf),
        anchor_step_ms=spans_ms("moby/anchor_step"),
        syncs=dict(unobserved=off_syncs, metrics_trace=mt_syncs,
                   all_on=full_syncs))
    print(f"observed kitti-urban x{OBS_FRAMES} on the card, twice each "
          f"(transform frames, medians): wall {split['frame_ms']:.2f} ms a frame with "
          f"metrics and the trace (unobserved {split['unobserved_frame_ms']:.2f}"
          f", every switch {split['all_on_frame_ms']:.2f}); host spans: "
          f"moby/transform_step (enqueue) {split['transform_step_ms']:.3f} "
          f"ms, moby/frame_stats_fetch (the wait on the card) "
          f"{split['frame_stats_fetch_ms']:.3f} ms, the rest of the frame "
          f"{split['frame_ms'] - split['transform_step_ms'] - split['frame_stats_fetch_ms']:.3f}"
          f" ms; synchronising calls: unobserved {off_syncs}, metrics and "
          f"trace {mt_syncs}, every switch {full_syncs}; reports equal the "
          f"unobserved run's bit for bit; audit rows and modelled trace "
          f"lanes match the CPU run", flush=True)

    fleet = api.scenario("fleet-16-congested")
    f_off = api.Session(fleet, torch_device="cuda").run(OBS_FLEET_FRAMES)
    f_on = api.Session(fleet, torch_device="cuda",
                       obs=cfg(True)).run(OBS_FLEET_FRAMES)
    if f_on.to_csv() != f_off.to_csv():
        fail("observability: the observed fleet differs from the unobserved")
    if len(f_on.obs.audit) != fleet.n_streams * OBS_FLEET_FRAMES or \
            not f_on.obs.gpu_busy or not f_on.obs.uplink_spans:
        fail("observability: the fleet's audit, cloud or uplink records "
             "are missing")
    scan_session = api.Session(fleet, torch_device="cuda", obs=cfg(False))
    s_on = scan_session.run(OBS_FLEET_FRAMES, scan=True)
    first = s_on.obs.measured[0]
    if first["name"] != "fleet/scan_dispatch" or not first.get("compiled"):
        fail(f"observability: scan mode's first span {first} is not a "
             f"compiled fleet/scan_dispatch")
    try:
        api.Session(fleet, torch_device="cuda",
                    obs=api.ObsConfig(audit=True)).run(2, scan=True)
    except ValueError as e:
        if "scan" not in str(e):
            raise
    else:
        fail("observability: scan mode took the audit")
    split.update(
        fleet_dispatch_ms=span_ms(f_on, "fleet/dispatch"),
        fleet_fetch_ms=span_ms(f_on, "fleet/fetch"),
        scan_dispatch_ms=first["dur"] * 1e3,
        scan_fetch_ms=span_ms(s_on, "fleet/scan_fetch"))
    print(f"observed fleet-16-congested x{OBS_FLEET_FRAMES} on the card: "
          f"orchestrated, every switch on, equals the unobserved run "
          f"({len(f_on.obs.audit)} audit rows, {len(f_on.obs.gpu_busy)} "
          f"cloud batches): fleet/dispatch {split['fleet_dispatch_ms']:.3f} "
          f"ms, fleet/fetch {split['fleet_fetch_ms']:.3f} ms (medians); "
          f"scan mode: fleet/scan_dispatch {split['scan_dispatch_ms']:.2f} ms"
          f" (compiled: the capture), fleet/scan_fetch "
          f"{split['scan_fetch_ms']:.3f} ms; scan mode refuses the audit",
          flush=True)
    print(json.dumps({"observability": split}), flush=True)
    return launches


def csv_rows(text: str):
    return list(csv.DictReader(io.StringIO(text)))


def compare_rows(got, want, what: str) -> None:
    """Kinds exact, floats within the golden tolerance; the first diverging
    frame is reported."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} rows vs {len(want)}")
    for g, w in zip(got, want):
        bad = [k for k in ("stream", "frame", "kind") if g[k] != w[k]]
        bad += [k for k in FLOAT_COLS if abs(float(g[k]) - float(w[k]))
                > ATOL + RTOL * abs(float(w[k]))]
        if bad:
            fail(f"{what}: first divergence at frame {g['frame']} in "
                 f"{bad}: got {dict(g)} want {dict(w)}")


PILLAR_CASES = ("kitti", "dense", "invalid", "ties", "specials", "one-pillar",
                "sorted", "rows-c7", "rows-c40", "unaligned")


def report_timing(name: str, r) -> None:
    """Turn a measured record's bytes and operations into its bound, and
    print its times and the kernels its calls launched."""
    n_bytes = r.pop("bytes")
    r["bound_ms"], r["bound_by"] = bound(n_bytes, r.pop("ops"),
                                         r.pop("peak", PEAK_F32_PER_S))
    lib_ms = r.get("library_ms")
    print(f"kernel {name} [{r['shape']}]: device {r['kernel_ms']:.5f} ms"
          f" (plain {r['plain_ms']:.4f} ms, library "
          f"{'-' if lib_ms is None else f'{lib_ms:.5f}'} ms), eager call "
          f"{r['kernel_eager_ms']:.4f} ms (plain {r['plain_eager_ms']:.4f}"
          f" ms), bound {r['bound_ms']:.6f} ms ({r['bound_by']}; "
          f"{n_bytes / 1e6:.2f} MB)"
          + (f", f32 SIMT bound {r['f32_simt_ms']:.5f} ms"
             if "f32_simt_ms" in r else "")
          + (f", exp2 floor {r['exp2_floor_ms']:.6f} ms (one exp2 a live "
             f"pair on the special-function units)"
             if "exp2_floor_ms" in r else "")
          + (f", rounds {r['rounds_sum']} (the longest auction "
             f"{r['rounds_max']}, {r['us_per_round']:.4f} us a round; "
             f"{r['bidders']} bids)"
             if "rounds_sum" in r else "")
          + (f", skeleton {r['skeleton_ms']:.5f} ms (the rounds' "
             f"synchronisation and end test alone)"
             if "skeleton_ms" in r else ""), flush=True)
    print("  " + kernels_line(f"{name} kernel", r["kernels"]), flush=True)
    if "library_kernels" in r:
        print("  " + kernels_line(f"{name} library",
                                  r["library_kernels"][:4]), flush=True)


def timing(r) -> dict:
    """The measured numbers of a record, as the JSON line gives them."""
    lib = r.get("library_kernels")
    return {"shape": r["shape"], "max_abs_err": r["max_abs_err"],
            "exact": r["exact"], "worst_over_tol": r.get("worst"),
            "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "eager_ms": r["kernel_eager_ms"],
            "plain_eager_ms": r["plain_eager_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "f32_simt_bound_ms": r.get(
                "f32_simt_ms"), "exp2_floor_ms": r.get("exp2_floor_ms"),
            "library_ms": r.get("library_ms"),
            "library_kernel": lib[0][0] if lib else None,
            "passes": [[k, ms] for k, ms, _ in r["kernels"]],
            **{k: r[k] for k in ("rounds_max", "rounds_sum", "bidders",
                                 "optimality_gap", "us_per_round",
                                 "skeleton_ms", "cases", "serve_wide_ms")
               if k in r}}


def kernel_entry(name: str, r, launches) -> dict:
    source, replaces = KERNELS[name]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, **timing(r)}
    for key in ("kitti", "f32_prefill", "bf16_hd64", "zamba2", "moonshot",
                "deepseek", "deepseek_f32_s2048", "tf32x3_seeded", "sorted",
                "whisper_self", "whisper_cross", "fleet_kitti", "fleet_16",
                "fleet_64"):
        if key in r:
            entry[key] = timing(r[key])
    return entry


def instance_entries(records, by_path) -> list:
    """The JSON entries of ``INSTANCES``: each its timed record, its label
    and the launches of its own path (None with ``--kernels``)."""
    out = []
    for (name, _), (key, label, path) in INSTANCES.items():
        if key in records.get(name, {}):
            launches = None if by_path is None else by_path[name][path]
            out.append(dict(kernel_entry(name, records[name][key], launches),
                            instance=label, path=path))
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(SRC))
    only = set()
    if sys.argv[1:2] == ["--kernels"] and len(sys.argv) == 3:
        only = set(sys.argv[2].split(","))
    elif sys.argv[1:]:
        fail(f"usage: {Path(__file__).name} [--kernels NAME[,NAME...]]")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    card = nvidia_smi()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    from repro_torch import api, kernels
    from repro_torch.data import scenes
    from repro_torch import configs as lm_configs, convert
    from repro_torch.kernels import _build
    from repro_torch.core import association
    from repro_torch.kernels.auction import ops as au_ops, ref as au_ref
    from repro_torch.kernels.decode_attention import ops as dec_ops, \
        ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, \
        ref as fa_ref
    from repro_torch.kernels.iou2d import ops as iou_ops, ref as iou_ref
    from repro_torch.kernels.mla_decode_attention import ops as mla_ops, \
        ref as mla_ref
    from repro_torch.kernels.pillar_scatter import ops as ps_ops, \
        ref as ps_ref
    from repro_torch.kernels.point_proj import ops as pp_ops, ref as pp_ref
    from repro_torch.kernels.ransac_score import ops as rs_ops, ref as rs_ref
    from repro_torch.models import decode, detector3d, layers, lm, params
    from repro_torch import ops, testing
    from repro_torch.train import loop, optimizer, trainstep
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           or m == "repro" for m in sys.modules):
        fail("the port pulled in jax or the JAX package")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(ROOT)}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line or "Performance Loss" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernels vs plain versions on the card --------------------------
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    def flash(*shape):
        return lambda s: check_flash(torch, dev, fa_ops, fa_ref, *shape, s)

    def dec(*shape):
        return lambda s: check_decode(torch, dev, dec_ops, dec_ref, *shape, s)

    def g1_edges(h, s, hd, b=16):
        """bf16 G = 1 at (b, h, s, hd) with lengths on and around the
        first, second and last boundaries of ``ops.g1_plan``'s units, 0, 1,
        S - 1 and S, the rest 31, 32, 33 and drawn ones."""
        span, units = dec_ops.g1_plan(s, b * h, hd,
                                      dec_ops._sm_count(dev.index))
        edges = {0, 1, s - 1, s} | {min(max(u * span + d, 0), s)
                                    for u in (1, 2, units - 1)
                                    for d in (-1, 0, 1)}
        edges = sorted(edges) + [31, 32, 33] + [(977 * i) % (s + 1)
                                                for i in range(b)]
        return b, h, h, s, hd, bf16, edges[:b]

    def flash_mla(b, h, s, hd, vd, dtype, causal):
        return lambda sd: check_flash(torch, dev, fa_ops, fa_ref, b, h, h, s,
                                      s, hd, dtype, causal, sd, vd=vd)

    def mla_dec(*shape):
        return lambda s: check_mla_decode(torch, dev, mla_ops, mla_ref,
                                          *shape, s)

    def flash_bwd(*shape, views=True, vd=None):
        return lambda s: check_flash_bwd(torch, dev, fa_ops, fa_ref, *shape,
                                         s, views, vd)

    def dec_bwd(*shape, empty=()):
        return lambda s: check_decode_bwd(torch, dev, dec_ops, dec_ref,
                                          *shape, s, empty)

    t0 = time.perf_counter()
    kitti, kitti_calib = kitti_frames(np, api, scenes,
                                      1 if only else DET_FRAMES)
    print(f"kitti-urban: {len(kitti)} frames of {KITTI['n_points']} points "
          f"rendered in {time.perf_counter() - t0:.1f} s", flush=True)

    def k4(kind, backward):
        return lambda s: check_pillar_scatter(
            torch, ps_ops, ps_ref,
            pillar_inputs(torch, np, dev, detector3d, kitti, kind, s),
            backward)

    def k1(check, *shape, unaligned=False):
        return lambda s: check(torch, pp_ops, pp_ref, *proj_inputs(
            torch, np, dev, scenes, *shape, s, unaligned))

    def k1_fleet(*shape, what=""):
        return lambda s: check_labels_fleet(
            torch, pp_ops, pp_ref,
            *proj_fleet_inputs(torch, np, dev, scenes, *shape, s), what)

    def k2(n, m, streams=None):
        return lambda s: check_iou2d(torch, np, dev, iou_ops, iou_ref, n, m,
                                     s, streams)

    def k3(o, k, p, dead=None):
        return lambda s: check_ransac(torch, np, dev, rs_ops, rs_ref, o, k,
                                      p, s, dead)

    def auction_synthetic(n, batch, seed, zero_rows=False, equal_rows=False,
                          what="", max_iter=4000):
        def case(_):
            rec, kern, plain = check_auction(
                torch, np, au_ops, au_ref, association.hungarian_numpy,
                torch.from_numpy(auction_benefits(
                    np, n, batch, seed, zero_rows, equal_rows)).to(dev),
                what, max_iter=max_iter, skeleton=n > 128)
            rec["time_plain"] = (n, batch) in AUCTION_PLAIN_TIMED and \
                not (zero_rows or equal_rows)
            return rec, kern, plain
        return case

    real_auctions = {}
    # The wide instance's resident tier ends at this n on this card.
    wide_bound = au_ops.resident_max_n(au_ops.smem_optin(dev))

    def auction_real(key):
        """The benefits of a kitti-urban transform frame (frame 2 of a run
        on the card; ``kitti_wide``: with max_obj = 80, n = 160) or of the
        full-width fleet's transform branch (frame 1), recorded from the
        serving path."""
        def case(_):
            if key not in real_auctions:
                name, overrides, frames = {
                    "kitti": ("kitti-urban", KITTI, 3),
                    "kitti_wide": ("kitti-urban",
                                   dict(KITTI, max_obj=WIDE_MAX_OBJ), 3),
                    "fleet": (FLEETS[2][0], FLEETS[2][1], 2)}[key]
                scn = api.scenario(name, seed=0, **overrides)
                real_auctions[key] = record_auctions(
                    torch, au_ops, lambda: api.Session(
                        scn, torch_device="cuda").run(frames))[-1]
            b = real_auctions[key]
            label = {"kitti": "kitti-urban frame 2",
                     "kitti_wide": f"kitti-urban max_obj={WIDE_MAX_OBJ} "
                                   f"frame 2",
                     "fleet": "full-width fleet frame 1, transform "
                              "branch"}[key]
            return check_auction(torch, np, au_ops, au_ref,
                                 association.hungarian_numpy, b,
                                 f" ({label})", count_bidders=True)
        return case

    def k1_kitti(_):
        """Frame 0 of kitti-urban: its own points, instance-id image and
        calibration, the data of the serving path's launches."""
        pts, _, _, lab = kitti[0]
        return check_point_proj_labels(
            torch, pp_ops, pp_ref,
            on_card(torch, dev, np.ascontiguousarray(pts[:, :3]), False),
            *(torch.from_numpy(a).to(dev) for a in (*kitti_calib, lab)),
            " (kitti-urban frame 0)")
    checks = {
        # The serving shape, a million points (N % 4 = 3), an unaligned
        # base, a small image with N % 4 = 1.
        "point_proj": [
            k1(check_point_proj, 122880, 375, 1242),
            k1(check_point_proj, 1000003, 375, 1242),
            k1(check_point_proj, 5001, 375, 1242, unaligned=True),
            k1(check_point_proj, 77, 48, 160)],
        # The labels instance: the serving shape, kitti-urban frame 0 (also
        # timed), an unaligned base, N = 77; then with a stream axis: the
        # three fleets' shapes (all timed: the full-width fleet, 16 streams
        # at KITTI's size; fleet-16-congested; fleet-64-mixed, S = 64), S =
        # 1 and a ragged S = 3 (N % 128 != 0).
        "point_proj_labels": [
            k1(check_point_proj_labels, 122880, 375, 1242),
            k1_kitti,
            k1(check_point_proj_labels, 5001, 375, 1242, unaligned=True),
            k1(check_point_proj_labels, 77, 48, 160),
            k1_fleet(16, 122880, 375, 1242, what=" (full-width fleet)"),
            k1_fleet(16, 2048, 64, 208, what=" (fleet-16-congested)"),
            k1_fleet(64, 512, 32, 104, what=" (fleet-64-mixed)"),
            k1_fleet(1, 5001, 375, 1242),
            k1_fleet(3, 4099, 48, 160)],
        # The serving shape, a multi-CTA grid, one output, and the two
        # sides of the one-CTA limit (1024 outputs); then with a stream
        # axis: the three fleets' shapes (timed), S = 1, a ragged S = 3
        # across the one-CTA limit, S = 64 with multi-CTA matrices.
        "iou2d": [k2(24, 12), k2(130, 250), k2(1, 1), k2(32, 32),
                  k2(33, 33), k2(24, 12, 16), k2(16, 8, 16), k2(12, 6, 64),
                  k2(24, 12, 1), k2(33, 33, 3), k2(130, 250, 64)],
        # The serving shape and others; then the fleets' S x O objects
        # (timed): 16 x 12, 16 x 8 and 64 x 6.
        "ransac_score": [k3(12, 30, 256), k3(20, 30, 256), k3(3, 7, 1000),
                         k3(1, 1, 1), k3(5, 33, 33, dead=2), k3(2, 5, 4000),
                         k3(192, 30, 256), k3(128, 30, 256),
                         k3(384, 30, 256)],
        # The 3xTF32 route (f32; bf16 at hd 16 and 32): LM B's prefill
        # shape first (full width in f32), LM C's prefill shape in f32 (also
        # timed), then GQA, ragged MQA, keys longer than queries, the SMOKE
        # configs' head dim, bf16 at hd 32 (bf16 at hd 64 takes the
        # tensor-core route: its cases are below).
        "flash_attention": [
            flash(LM_B_BATCH, 16, 2, LM_B_S, LM_B_S, 128, f32, True),
            flash(PREFILL_B, 16, 2, PREFILL_S, PREFILL_S, 128, f32, True),
            flash(2, 8, 2, 512, 512, 128, f32, True),
            flash(1, 4, 1, 300, 300, 64, f32, True),
            flash(2, 2, 2, 128, 640, 64, f32, False),
            flash(2, 4, 2, 16, 16, 16, f32, True),
            flash(2, 8, 2, 512, 512, 32, bf16, True),
            # MLA's head dims (qk 192 / value 128; SMOKE's 24 / 16): MLA B's
            # prefill shape (B 2, 128 heads, S 256, also timed), full
            # attention, MLA A's SMOKE shape (also timed), a ragged tile.
            flash_mla(LM_B_BATCH, 128, LM_B_S, 192, 128, f32, True),
            flash_mla(1, 8, 300, 192, 128, f32, False),
            flash_mla(2, 4, 16, 24, 16, f32, True),
            flash_mla(2, 4, 77, 24, 16, f32, False),
            # The persistent (192, 128) instance away from the wave tail (B
            # 1, 128 heads, S 2048, also timed), and runs of several ragged
            # items a block.
            flash_mla(1, 128, 2048, 192, 128, f32, True),
            flash_mla(3, 48, 333, 192, 128, f32, True),
            # SMOKE's (24, 16) in bf16 (deepseek-v2's SMOKE dtype: MLA A
            # bf16's shape, also timed), full attention on a ragged tile.
            flash_mla(2, 4, 16, 24, 16, bf16, True),
            flash_mla(2, 4, 77, 24, 16, bf16, False)],
        # The tensor-core route (bf16 at hd 128): the prefill shape of LM
        # phase C first, then a ragged causal tile, keys longer than
        # queries, GQA.
        "flash_attention_tc": [
            flash(PREFILL_B, 16, 2, PREFILL_S, PREFILL_S, 128, bf16, True),
            flash(1, 4, 1, 300, 300, 128, bf16, True),
            flash(2, 2, 2, 128, 640, 128, bf16, False),
            flash(2, 8, 2, 512, 512, 128, bf16, True),
            # MoE C's prefill shape (moonshot: one query head a kv head,
            # also timed), then G = 1 on a ragged causal tile.
            flash(PREFILL_B, 16, 16, PREFILL_S, PREFILL_S, 128, bf16, True),
            flash(2, 4, 4, 77, 77, 128, bf16, True),
            # MLA C's prefill shape (deepseek-v2: 128 heads of qk dim 192 /
            # value dim 128, one query head a kv head, also timed), then a
            # ragged causal tile and full attention.
            flash_mla(PREFILL_B, 128, PREFILL_S, 192, 128, bf16, True),
            flash_mla(1, 4, 300, 192, 128, bf16, True),
            flash_mla(2, 8, 77, 192, 128, bf16, False),
            # hd 64 (zamba2, whisper): zamba2-1.2b's prefill (32 heads a
            # kv head each, S 8192, also timed), GQA, whisper-small's
            # encoder (12 heads, 1,500 frames, full) and cross attention
            # (448 queries over the 1,500 frames), Sq = Sk = 1, a ragged
            # causal 77, G = 8 on a ragged tile.
            flash(PREFILL_B, 32, 32, PREFILL_S, PREFILL_S, 64, bf16, True),
            flash(2, 8, 2, 512, 512, 64, bf16, True),
            flash(1, 12, 12, 1500, 1500, 64, bf16, False),
            flash(1, 12, 12, 448, 1500, 64, bf16, False),
            flash(2, 4, 4, 1, 1, 64, bf16, True),
            flash(2, 4, 4, 77, 77, 64, bf16, True),
            flash(1, 16, 2, 300, 300, 64, bf16, True),
            # The ported configs' other query heads a kv head: G = 3
            # (minitron-4b), 6 (qwen2-vl), 16 (glm4-9b) and 48
            # (granite-20b's MQA).
            flash(1, 6, 2, 300, 300, 128, bf16, True),
            flash(2, 12, 2, 77, 77, 128, bf16, True),
            flash(1, 32, 2, 300, 300, 128, bf16, True),
            flash(1, 48, 1, 200, 200, 128, bf16, True),
            # VLM C's prefill (qwen2-vl-2b: 12 heads over 2 kv heads, G =
            # 6), then Audio C's three (whisper-small, 16 requests, 12
            # heads a kv head each): the encoder over 1,500 frames (full),
            # the decoder's self attention over its 227-token prefill
            # (causal) and its cross attention (227 over 1,500); all four
            # timed.
            flash(PREFILL_B, 12, 2, PREFILL_S, PREFILL_S, 128, bf16, True),
            flash(AUDIO_C_B, 12, 12, 1500, 1500, 64, bf16, False),
            flash(AUDIO_C_B, 12, 12, AUDIO_C_S, AUDIO_C_S, 64, bf16, True),
            flash(AUDIO_C_B, 12, 12, AUDIO_C_S, 1500, 64, bf16, False)],
        # The decode shape of LM phase C first (ragged positions), then
        # f32 GQA, MQA with positions 1 and S, SMOKE's head dim with an
        # empty request, and bf16 at hd 16 (2-byte rows of V a lane).
        "decode_attention": [
            dec(DECODE_B, 16, 2, DECODE_MAX, 128, bf16,
                (DECODE_POS_LO, DECODE_MAX)),
            dec(4, 8, 2, 1024, 128, f32, (1, 1025)),
            dec(2, 8, 1, 700, 64, f32, [1, 700]),
            dec(2, 4, 2, 32, 16, f32, [0, 17]),
            dec(2, 4, 2, 100, 16, bf16, [0, 97]),
            # MoE C's decode shape (moonshot: G = 1, also timed), then G = 1
            # with ragged positions and an empty request.
            dec(DECODE_B, 16, 16, DECODE_MAX, 128, bf16,
                (DECODE_POS_LO, DECODE_MAX)),
            dec(3, 4, 4, 300, 128, bf16, [0, 77, 300]),
            # G = 3, 6, 16 and 48 (the ported configs'; 8 heads a block,
            # so partial and several head groups), ragged, empty requests.
            dec(3, 6, 2, 700, 128, bf16, [0, 77, 700]),
            dec(2, 12, 2, 1000, 128, f32, [1, 1000]),
            dec(2, 32, 2, 600, 128, bf16, [600, 333]),
            dec(2, 48, 1, 500, 128, bf16, [0, 500]),
            # VLM C's decode shape (qwen2-vl-2b, G = 6), then the bf16 hd-64
            # instance at Audio C's (whisper-small, G = 1): its self cache
            # of 448 with ragged positions and an empty request, its cross
            # caches at 1,500 everywhere; all three timed.
            dec(DECODE_B, 12, 2, DECODE_MAX, 128, bf16,
                (DECODE_POS_LO, DECODE_MAX)),
            dec(AUDIO_C_B, 12, 12, AUDIO_C_CACHE, 64, bf16,
                [0, AUDIO_C_CACHE, 1, 77, 200, 300, AUDIO_C_CACHE - 1, 64,
                 128, 256, 333, 400, 5, 17, 100, 250]),
            dec(AUDIO_C_B, 12, 12, 1500, 64, bf16, [1500] * AUDIO_C_B),
            # The G = 1 layout's edges (bf16, ``ops.g1_plan``): lengths 1,
            # 31, 32, 33; lengths on and around its units' boundaries,
            # S and an empty request, several units a row (the combine) at
            # hd 64, 32 and 128; S off the tile (1,499); hd 16 with B*H at
            # the grid's limit of rows (65,535); more rows than the card
            # holds blocks and units capped at G1_MAX_SPAN, ragged.
            dec(4, 4, 4, 700, 64, bf16, [1, 31, 32, 33]),
            dec(*g1_edges(1, 2000, 64)),
            dec(*g1_edges(2, 1000, 32)),
            dec(*g1_edges(1, 9000, 128)),
            dec(2, 4, 4, 1499, 64, bf16, [1499, 1498]),
            dec(3, 4, 4, 300, 16, bf16, [0, 77, 300]),
            dec(21845, 3, 3, 33, 16, bf16, (0, 34)),
            dec(64, 8, 8, 8192, 64, bf16,
                [0, 1, 4095, 4096, 4097, 8191, 8192]
                + [(127 * i) % 8193 for i in range(57)])],
        # MLA's absorbed decode over the compressed cache: MLA C's decode
        # shape first (B 16, 128 heads, (R, P) = (512, 64), ragged lengths
        # over a 32k cache), then lengths 1 and S_max and lengths off the
        # tile and run boundaries, 100 heads (a partial head block) with
        # an empty request; the SIMT instance in f32 at MLA B's decode
        # shape and at SMOKE's (16, 8) (both also timed), in bf16 at
        # (16, 8), and in f32 with ragged lengths; then the tensor-core
        # instance's cluster shapes and schedule edges.
        "mla_decode_attention": [
            mla_dec(DECODE_B, 128, DECODE_MAX, 512, 64, bf16,
                    (DECODE_POS_LO, DECODE_MAX)),
            mla_dec(DECODE_B, 128, DECODE_MAX, 512, 64, bf16,
                    [1, DECODE_MAX, 31, 33, 4097, 8191, 8193, 12345, 20000,
                     32767, 2, 100, 1000, 5000, 30001, 16385]),
            mla_dec(3, 100, 700, 512, 64, bf16, [0, 77, 700]),
            mla_dec(LM_B_BATCH, 128, 512, 512, 64, f32, [LM_B_S + 4] * 2),
            mla_dec(2, 4, 32, 16, 8, f32, [1, 32]),
            mla_dec(3, 4, 100, 16, 8, bf16, [0, 1, 100]),
            mla_dec(4, 128, 2048, 512, 64, f32, (1, 2049)),
            # The tf32x3 instance (f32): a partial head group (100 heads)
            # with an empty request, more requests than runs, one request
            # over every run.
            mla_dec(3, 100, 700, 512, 64, f32, [0, 77, 700]),
            mla_dec(64, 128, 2048, 512, 64, f32, (1, 300)),
            mla_dec(1, 128, 8192, 512, 64, f32, [8192]),
            # The tensor-core instance's schedule and clusters: 64 heads (a
            # cluster of one CTA), 65 (a second CTA of one head), one
            # request of 32,768 positions spread over every cluster, 64
            # short ragged requests (more requests than clusters), an
            # empty request between live ones.
            mla_dec(2, 64, 700, 512, 64, bf16, [700, 333]),
            mla_dec(2, 65, 700, 512, 64, bf16, [1, 700]),
            mla_dec(1, 128, DECODE_MAX, 512, 64, bf16, [DECODE_MAX]),
            mla_dec(64, 128, 2048, 512, 64, bf16, (1, 300)),
            mla_dec(5, 128, 1000, 512, 64, bf16, [500, 64, 0, 129, 1000])],
        # K5's gradient, the 3xTF32 route (f32; bf16 at hd 16 and 32): LM
        # T's shape in f32 first (timed), then LM T's f32 correctness
        # shape, G = 1, 4 and 8, Sq = Sk = 1, 77, 256 and 4096, causal and
        # not, every head dim in f32 and hd 32 in bf16, keys longer than
        # queries; then the dq kernel's other head groupings: G = 2 (two
        # heads a block), 3 (one head, 128 rows) and 16 (two blocks a kv
        # head), and bf16 at hd 16; each called twice, the two results
        # equal bit for bit; all as (B, S, heads, hd) views. (bf16 at hd
        # 64 takes the tensor-core route: its cases are below.)
        "flash_attention_bwd": [
            flash_bwd(T_BATCH, 16, 2, T_SEQ, T_SEQ, 128, f32, True),
            flash_bwd(LM_B_BATCH, 16, 2, LM_B_S, LM_B_S, 128, f32, True),
            flash_bwd(1, 4, 4, 77, 77, 16, f32, True),
            flash_bwd(2, 8, 2, 77, 77, 32, f32, False),
            flash_bwd(1, 8, 1, 256, 256, 64, f32, True),
            flash_bwd(2, 4, 1, 1, 1, 128, f32, True),
            flash_bwd(1, 4, 4, 1, 1, 32, bf16, False),
            flash_bwd(1, 8, 2, 4096, 4096, 64, f32, True),
            flash_bwd(1, 16, 2, 4096, 4096, 128, f32, False),
            flash_bwd(2, 8, 2, 77, 77, 32, bf16, True),
            flash_bwd(2, 4, 2, 128, 640, 64, f32, False),
            flash_bwd(1, 4, 2, 300, 300, 128, f32, True),
            flash_bwd(1, 6, 2, 150, 150, 64, f32, True),
            flash_bwd(1, 16, 1, 200, 200, 32, bf16, True),
            flash_bwd(2, 4, 2, 77, 77, 16, bf16, False),
            # MLA's head dims (qk 192 / value 128 in f32: 8-warp dq blocks
            # over 32-key tiles, 8-warp dkv blocks over 16-query tiles; qk
            # 24 / value 16 in f32 and bf16): MLA T's f32 correctness shape
            # (MLA B's) and MLA A's SMOKE shape (B 2, 4 heads, S 16) in f32
            # and bf16 (all three timed), then G = 4 and 3, ragged,
            # contiguous operands, keys longer than queries, Sq = Sk = 1,
            # S 1024.
            flash_bwd(LM_B_BATCH, 128, 128, LM_B_S, LM_B_S, 192, f32, True,
                      vd=128),
            flash_bwd(2, 4, 4, 16, 16, 24, f32, True, vd=16),
            flash_bwd(2, 4, 4, 16, 16, 24, bf16, True, vd=16),
            flash_bwd(1, 8, 2, 77, 77, 192, f32, False, vd=128),
            flash_bwd(1, 4, 4, 300, 300, 192, f32, True, views=False,
                      vd=128),
            flash_bwd(2, 6, 2, 300, 300, 24, f32, True, vd=16),
            flash_bwd(1, 4, 2, 128, 640, 24, bf16, False, vd=16),
            flash_bwd(2, 4, 4, 1, 1, 192, f32, True, vd=128),
            flash_bwd(1, 4, 4, 1024, 1024, 24, bf16, True, vd=16),
            # (192, 128) over 3 x 48 heads at a ragged S 333: 6 dq blocks
            # and 24 dkv blocks a head, the last tile of each ragged.
            flash_bwd(3, 48, 48, 333, 333, 192, f32, True, vd=128)],
        # The tensor-core route (bf16 at hd 64 and 128): LM T's timed shape
        # first (S 4096, G 8, causal), then Sq = Sk = 1, a ragged 77 with
        # contiguous operands, keys longer than queries (not causal), full
        # attention at S 256, the CPU model's shape (S 1024, causal), G = 1
        # (the direct write of dK and dV); then hd 64: LM T's shape (also
        # timed, against the 3xTF32 instance it replaced), zamba2-1.2b's
        # (32 heads, G = 1, S 4096, also timed), whisper-small's encoder
        # (12 heads, 1,500 frames, full) and cross attention (448 queries
        # over 1,500 frames), Sq = Sk = 1, a ragged 77 with contiguous
        # operands, G = 2 and G = 8; each also called twice, the two
        # results equal bit for bit, and at G = 1 held bit for bit to the
        # partials' group sum (``group_sum_path``).
        "flash_attention_bwd_tc": [
            flash_bwd(T_BATCH, 16, 2, T_SEQ, T_SEQ, 128, bf16, True),
            flash_bwd(2, 4, 1, 1, 1, 128, bf16, True),
            flash_bwd(2, 8, 2, 77, 77, 128, bf16, True, views=False),
            flash_bwd(2, 8, 2, 128, 640, 128, bf16, False),
            flash_bwd(1, 16, 2, 256, 256, 128, bf16, False),
            flash_bwd(1, 4, 2, 1024, 1024, 128, bf16, True),
            flash_bwd(1, 4, 4, 300, 300, 128, bf16, True),
            flash_bwd(T_BATCH, 16, 2, T_SEQ, T_SEQ, 64, bf16, True),
            flash_bwd(1, 32, 32, T_SEQ, T_SEQ, 64, bf16, True),
            flash_bwd(1, 12, 12, 1500, 1500, 64, bf16, False),
            flash_bwd(1, 12, 12, 448, 1500, 64, bf16, False),
            flash_bwd(2, 4, 4, 1, 1, 64, bf16, True),
            flash_bwd(2, 8, 8, 77, 77, 64, bf16, True, views=False),
            flash_bwd(1, 8, 4, 300, 300, 64, bf16, True),
            flash_bwd(2, 8, 1, 256, 256, 64, bf16, False),
            # qk 192 / value 128 (MLA): MLA T's shape (128 heads, a kv
            # head each, S 4096, causal; its plain version 8 heads at a
            # time; timed), then moonshot's MoE T shape at hd 128 (16
            # heads, G = 1, S 4096; timed), then Sq = Sk = 1, a ragged 77
            # with contiguous operands, keys longer than queries at G = 4
            # (the partials' group sum), S 1024 causal at G = 2, G = 1 at
            # a ragged 300 (held to the group sum bit for bit).
            flash_bwd(T_BATCH, 128, 128, T_SEQ, T_SEQ, 192, bf16, True,
                      vd=128),
            flash_bwd(T_BATCH, 16, 16, T_SEQ, T_SEQ, 128, bf16, True),
            flash_bwd(2, 4, 4, 1, 1, 192, bf16, True, vd=128),
            flash_bwd(2, 8, 8, 77, 77, 192, bf16, True, views=False,
                      vd=128),
            flash_bwd(2, 8, 2, 128, 640, 192, bf16, False, vd=128),
            flash_bwd(1, 4, 2, 1024, 1024, 192, bf16, True, vd=128),
            flash_bwd(1, 4, 4, 300, 300, 192, bf16, True, vd=128),
            # The persistent (192, 128) kernels over items that no wave of
            # 132 CTAs divides (3 x 48 heads, S 333: 432 items of each
            # kernel), the last tile of each ragged.
            flash_bwd(3, 48, 48, 333, 333, 192, bf16, True, vd=128)],
        # K6's gradient: LM C's decode shape with ragged positions and one
        # empty request first, then f32 GQA, MQA with positions 1 and S,
        # SMOKE's head dim with an empty request, bf16 at hd 16, and 48
        # query heads a kv head (granite-20B's MQA); each called twice,
        # the two results equal bit for bit.
        "decode_attention_bwd": [
            dec_bwd(DECODE_B, 16, 2, DECODE_MAX, 128, bf16,
                    (DECODE_POS_LO, DECODE_MAX), empty=(3,)),
            dec_bwd(4, 8, 2, 1024, 128, f32, (1, 1025)),
            dec_bwd(2, 8, 1, 700, 64, f32, [1, 700]),
            dec_bwd(2, 4, 2, 32, 16, f32, [0, 17]),
            dec_bwd(2, 4, 2, 100, 16, bf16, [0, 97]),
            dec_bwd(3, 48, 1, 300, 128, bf16, [5, 256, 300]),
            # G = 3 (a partial head group) with an empty request, G = 16
            # (two groups) in f32 and in bf16 at hd 64.
            dec_bwd(3, 6, 2, 700, 128, bf16, [0, 77, 700]),
            dec_bwd(2, 32, 2, 600, 128, f32, [1, 600]),
            dec_bwd(2, 32, 2, 333, 64, bf16, [333, 5])],
        # Det B's shape first (the real pillar ids of a kitti-urban frame),
        # then dense collisions, every point masked out, planted ties,
        # special values, one pillar, sorted points, 7- and 40-channel
        # rows, an unaligned base.
        "pillar_scatter": [k4(kind, False) for kind in PILLAR_CASES],
        "pillar_scatter_bwd": [k4(kind, True) for kind in PILLAR_CASES],
        # A kitti-urban transform frame's benefits (the serving shape) and
        # the full-width fleet's (both measured in full), then seeded tied
        # benefits at every n and batch, zero rows and columns, every row
        # equal, all zeros (each timed too).
        "auction": [auction_real("kitti"), auction_real("fleet")]
        + [auction_synthetic(n, batch, 100 * n + batch)
           for n in AUCTION_NS for batch in AUCTION_BATCHES]
        + [auction_synthetic(24, 16, 1, zero_rows=True, what=" zero rows"),
           auction_synthetic(40, 64, 2, zero_rows=True, what=" zero rows")]
        + [auction_synthetic(n, batch, 3 * n, equal_rows=True,
                             what=" all tied")
           for n, batch in ((24, 16), (33, 4), (40, 16), (128, 1))]
        + [lambda _: check_auction(torch, np, au_ops, au_ref,
                                   association.hungarian_numpy,
                                   torch.zeros((1, 24, 24), device=dev),
                                   " all zeros")],
        # The wide instance (n > 128): the benefits of a kitti-urban
        # transform frame at max_obj = 80 (n = 160, measured in full), then
        # seeded tied benefits at n = 129 to 1024, one auction and 16, at
        # the card's resident bound and one past it, zero rows and columns,
        # every row equal (each timed too).
        "auction_wide": [auction_real("kitti_wide")]
        + [auction_synthetic(n, batch, 100 * n + batch,
                             max_iter=WIDE_MAX_ITER)
           for n in AUCTION_WIDE_NS for batch in AUCTION_WIDE_BATCHES]
        + [auction_synthetic(n, 1, 100 * n + 1, max_iter=WIDE_MAX_ITER,
                             what=f" ({tier})")
           for n, tier in ((wide_bound, "resident bound"),
                           (wide_bound + 1, "streamed"))]
        + [auction_synthetic(n, 1, seed, zero_rows=True, what=" zero rows",
                             max_iter=WIDE_MAX_ITER)
           for n, seed in ((160, 7), (256, 5))]
        + [auction_synthetic(n, 1, seed, equal_rows=True, what=" all tied",
                             max_iter=WIDE_MAX_ITER)
           for n, seed in ((160, 8), (256, 6))],
    }
    # Besides each kernel's first case (the serving path's shape), these
    # are timed too: (kernel, case) -> key of its record.
    also_timed = {("point_proj_labels", 1): "kitti",
                  ("point_proj_labels", 4): "fleet_kitti",
                  ("point_proj_labels", 5): "fleet_16",
                  ("point_proj_labels", 6): "fleet_64",
                  ("iou2d", 5): "fleet_kitti", ("iou2d", 6): "fleet_16",
                  ("iou2d", 7): "fleet_64",
                  ("ransac_score", 6): "fleet_kitti",
                  ("ransac_score", 7): "fleet_16",
                  ("ransac_score", 8): "fleet_64",
                  ("flash_attention", 1): "f32_prefill",
                  ("flash_attention", 11): "deepseek_f32_s2048",
                  ("mla_decode_attention", 6): "tf32x3_seeded",
                  ("flash_attention_tc", 4): "moonshot",
                  ("flash_attention_tc", 9): "zamba2",
                  ("flash_attention_bwd_tc", 7): "bf16_hd64",
                  ("flash_attention_bwd_tc", 8): "zamba2",
                  ("decode_attention", 5): "moonshot",
                  ("flash_attention_tc", 22): "whisper_self",
                  ("flash_attention_tc", 23): "whisper_cross",
                  ("decode_attention", 13): "whisper_cross",
                  **{case: key for case, (key, _, _) in INSTANCES.items()},
                  ("auction", 1): "fleet_kitti",
                  ("pillar_scatter", PILLAR_CASES.index("sorted")): "sorted"}
    # The launch floor: a one-element zero_() timed as the kernels are.
    floor_t = torch.zeros(1, device=dev)
    launch_floor = graph_ms(floor_t.zero_, torch)
    print(f"launch floor: {launch_floor:.5f} ms a call (a one-element "
          f"zero_(), CUDA-graph replays as for the kernels)", flush=True)
    records = {}
    for name, cases in checks.items():
        if only and name not in only:
            continue
        for i, case in enumerate(cases):
            rec, kern, plain = case(i)
            time_plain = rec.pop("time_plain", False)
            torch.cuda.synchronize()
            print(f"kernel {name} [{rec['shape']}]: matches the plain version"
                  f" (max abs err {rec['max_abs_err']}"
                  + (f", tolerance {rec['tol']}" if "tol" in rec else "")
                  + ")", flush=True)
            if i == 0 or (name, i) in also_timed:
                measure(torch, rec, kern, plain)
                report_timing(name, rec)
                if i == 0:
                    records[name] = rec
                else:
                    records[name][also_timed[name, i]] = rec
            elif name in ("auction", "auction_wide"):
                time_auction(torch, rec, kern, plain if time_plain else None)
                records[name].setdefault("cases", []).append(
                    [rec["shape"], rec["kernel_ms"], rec["us_per_round"],
                     rec["rounds_max"], rec["plain_ms"], rec["skeleton_ms"]])
            del rec, kern, plain
            torch.cuda.empty_cache()
    if only:
        print(json.dumps({"kernels": [kernel_entry(name, records[name], None)
                                      for name in records]
                          + instance_entries(records, None)}))
        return
    main_launches = {}

    # -- 4. KITTI-size serving on the card ---------------------------------
    scn = api.scenario("kitti-urban", seed=0, **KITTI)
    # Warm-up (CUDA context, cuSOLVER, allocator) outside the timed run.
    api.Session(scn, torch_device="cuda").run(2)
    session = api.Session(scn, torch_device="cuda")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(KITTI_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    kinds = report.kinds()
    n_transform = sum(k != "anchor" for k in kinds)
    # The serving path launches K1's labels instance, never the full one.
    expect = dict.fromkeys(launches, 0)
    expect.update(point_proj_labels=n_transform, iou2d=KITTI_FRAMES,
                  ransac_score=n_transform, auction=KITTI_FRAMES)
    if launches != expect:
        fail(f"launch counts {launches} != {expect} implied by kinds {kinds}")
    main_launches.update((k, launches[k]) for k in MOBY_KERNELS)
    walls = session.engine.frame_wall_s
    per_kind = {k: statistics.median(w for w, kk in zip(walls, kinds)
                                     if (kk == "anchor") == (k == "anchor"))
                * 1e3 for k in ("anchor", "transform")}
    print(f"serve kitti-urban x{KITTI_FRAMES} on the card: {wall:.2f} s, "
          f"kinds {''.join(k[0] for k in kinds)}, launches {launches}, "
          f"median wall ms/frame: transform {per_kind['transform']:.2f}, "
          f"anchor {per_kind['anchor']:.2f}, mean F1 {report.mean_f1:.4f}",
          flush=True)
    print(profile_window(
        torch, scn.name,
        lambda: api.Session(scn, torch_device="cuda").run(4), 4, "frame"),
        flush=True)
    gpu_rows = csv_rows(report.to_csv())
    if not all(math.isfinite(float(r[k])) for r in gpu_rows
               for k in FLOAT_COLS):
        fail("non-finite values in the card's report")

    # -- 5. the same run on the CPU -----------------------------------------
    t0 = time.perf_counter()
    cpu_report = api.Session(scn, torch_device="cpu").run(KITTI_FRAMES)
    compare_rows(gpu_rows, csv_rows(cpu_report.to_csv()),
                 "kitti-urban card vs CPU")
    print(f"serve kitti-urban x{KITTI_FRAMES} on the CPU: "
          f"{time.perf_counter() - t0:.2f} s; the card's report matches it",
          flush=True)
    by_path = {k: {"kitti-urban": main_launches[k]} for k in MOBY_KERNELS}

    # -- 5b. past 128 persons: kitti-urban with max_obj = 80 -----------------
    launches, records["auction_wide"]["serve_wide_ms"] = serve_wide(
        torch, api, kernels)
    for k in by_path:
        by_path[k][f"kitti-urban max_obj={WIDE_MAX_OBJ}"] = launches[k]
        main_launches[k] += launches[k]

    # -- 5c. observability on the card ----------------------------------------
    launches = serve_observed(torch, api, kernels)
    for k in by_path:
        by_path[k]["kitti-urban observed"] = launches[k]
        main_launches[k] += launches[k]
    torch.cuda.empty_cache()

    # -- 6. the fleet, orchestrated mode ------------------------------------
    fleets = []
    for name, overrides, frames, cpu_frames, key in FLEETS:
        launches, run = serve_fleet(torch, api, kernels, name, overrides,
                                    frames, cpu_frames,
                                    profile=key == "fleet_kitti")
        path = f"{key} ({name})"
        for k in by_path:
            by_path[k][path] = launches[k]
            main_launches[k] += launches[k]
        fleets.append(run)
        torch.cuda.empty_cache()
    print(json.dumps({"fleets": fleets}), flush=True)

    # -- 6b. the fleet, scan mode: one CUDA graph of the frame, replayed --
    from repro_torch.fleet.engine import report_from_packed
    scans = []
    for name, overrides, frames, cpu_frames, key in FLEETS:
        launches, run = serve_scan(torch, api, kernels, report_from_packed,
                                   name, overrides, frames, cpu_frames)
        path = f"scan {key} ({name})"
        for k in by_path:
            by_path[k][path] = launches[k]
            main_launches[k] += launches[k]
        scans.append(run)
        torch.cuda.empty_cache()
    scan_golden(torch, api)
    print(json.dumps({"scans": scans}), flush=True)

    # -- 7. smoke on the card vs the JAX reference's golden -----------------
    smoke = api.Session(api.scenario("smoke", seed=0),
                        torch_device="cuda").run(16)
    compare_rows(csv_rows(smoke.to_csv()), csv_rows(GOLDEN.read_text()),
                 "smoke on the card vs tests/goldens/smoke.csv")
    print("smoke x16 on the card matches tests/goldens/smoke.csv", flush=True)

    # -- 8-10. LM A-C: qwen2.5-3B against JAX's golden and the CPU, then
    # serving at full width on the card --------------------------------------
    lm_paths = {}
    serve_families(torch, np, dev, kernels, lm_configs, convert, lm, decode,
                   params, layers, (("LM", LM_ARCH, LM_GOLDEN, 1, 3),),
                   main_launches, lm_paths)

    # -- 10b-10g. MoE A-C (moonshot-v1-16b-a3b), MLA A-C (deepseek-v2) -----
    for label, arch, golden, b_layers, b_seed, c_layers, c_seed in (
            ("MoE", MOE_ARCH, MOE_GOLDEN, MOE_B_LAYERS, 6, MOE_C_LAYERS, 8),
            ("MLA", MLA_ARCH, MLA_GOLDEN, MLA_B_LAYERS, 9, MLA_C_LAYERS, 11)):
        torch.cuda.empty_cache()
        for k, paths in check_moe(torch, np, dev, kernels, lm_configs,
                                  convert, lm, decode, params, layers, label,
                                  arch, golden, b_layers, b_seed).items():
            for path, n in paths.items():
                main_launches[k] = main_launches.get(k, 0) + n
                lm_paths.setdefault(k, {})[path] = n
        torch.cuda.empty_cache()
        for k, n in serve_moe(torch, dev, kernels, lm_configs, lm, decode,
                              params, layers, label, arch, c_layers,
                              c_seed).items():
            main_launches[k] = main_launches.get(k, 0) + n
            lm_paths.setdefault(k, {})[f"{label} C serving"] = n

    # -- 10h-10m. VLM A-C (qwen2-vl-2b), Audio A-C (whisper-small) ---------
    serve_families(torch, np, dev, kernels, lm_configs, convert, lm, decode,
                   params, layers,
                   (("VLM", VLM_ARCH, VLM_GOLDEN, 51, 53),
                    ("Audio", AUDIO_ARCH, AUDIO_GOLDEN, 61, 63)),
                   main_launches, lm_paths)

    # -- 11. LM T: training qwen2.5-3B on the card -------------------------
    torch.cuda.empty_cache()
    check_gradients_reach(torch, dev, ops, fa_ops, dec_ops)
    check_matmul_grad(torch, dev, layers)
    training = train_lm(torch, dev, kernels, lm_configs, lm, params,
                        optimizer, trainstep, loop)
    for k, n in training.items():
        main_launches[k] = main_launches.get(k, 0) + n
        lm_paths.setdefault(k, {})["LM T training"] = n

    # -- 11b. MoE T and MLA T: training the moe family on the card ---------
    torch.cuda.empty_cache()
    check_bmm_grad(torch, dev, layers, lm_configs.get(MOE_ARCH),
                   T_BATCH * T_SEQ)
    trained = [("flash_attention_bwd", path, n) for path, n in
               train_smoke(torch, dev, kernels, lm_configs, lm, params,
                           optimizer, trainstep, "MLA", MLA_ARCH,
                           41).items()]
    for label, arch, check_layers, timed_layers, seed, accums, adamw in (
            ("MoE", MOE_ARCH, MOE_T_CHECK_LAYERS, MOE_T_LAYERS, 21,
             (1, 1, 1, 2), True),
            ("MLA", MLA_ARCH, MLA_T_CHECK_LAYERS, MLA_T_LAYERS, 31, (1,),
             False)):
        torch.cuda.empty_cache()
        res = train_moe(torch, dev, kernels, lm_configs, lm, params,
                        optimizer, trainstep, layers, label, arch,
                        check_layers, timed_layers, seed, accums, adamw)
        trained.append(("flash_attention_bwd", f"{label} T f32 correctness",
                        res.pop("flash_attention_bwd")))
        trained += [(k, f"{label} T training", n) for k, n in res.items()]
    for k, path, n in trained:
        main_launches[k] = main_launches.get(k, 0) + n
        lm_paths.setdefault(k, {})[path] = n
    by_path.update(lm_paths)

    # -- 12-13. Det A and B: the PointPillars detector ----------------------
    torch.cuda.empty_cache()
    check_detector_golden(testing)
    main_launches.update(serve_detector(torch, dev, kernels, detector3d,
                                        params, optimizer, testing, kitti))

    # -- 14. result lines -----------------------------------------------------
    entries = [kernel_entry(name, records[name], main_launches[name])
               for name in KERNELS]
    for e in entries:
        if e["name"] in by_path:
            e["launches_by_path"] = by_path[e["name"]]
    entries += instance_entries(records, by_path)
    print(json.dumps({"kernels": entries}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
