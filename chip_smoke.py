#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (uvg266_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (or a few), any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from uvg266_tpu_torch/csrc/ (one nvcc per
     source, all at once), with the build time;
  3. each kernel of the all-intra search (K1 refs_blocks_grid, K2
     predict67, K3 satd67, K4 rd_cost), at the shapes of an 832x480 frame
     (the four classes 64x64 .. 8x8), held against its plain PyTorch
     version on the same card inputs (the frame, random and edge inputs at
     8 and 10 bits, and K1 with a separate reference plane): integer
     outputs equal, rd costs equal (both sides run the same float32
     operations in the same order: tolerance 0); K2 and K4 also at the
     BT/TT shapes 32x8, 8x32, 64x16, 16x64, 4x16 and 16x4 (K2 over all 67
     modes and the 35 of the rough search, K4 over 67, 35, 16 and 12
     candidates, on the class grid, on one block and on 37 blocks, and at
     the largest residual), and K1 and K12a at the BT/TT shapes and
     where the 3w+3 top line leaves the plane (grids leaving it, origins
     off the 4-sample grid, two frames with a separate reference plane).
     Times from CUDA events over 20 calls (and, for K1-K4, K6 and
     K9a-K12b, over 20 calls captured in a CUDA graph and replayed: their
     device time without the host's launch path; also K5, K7 and K8 in
     phase 4), launches
     per frame and the least time the card could take (bytes over 3.35
     TB/s or operations over 67 T/s);
  4. the same for the inter kernels at 832x480: K5 pseudo_recon (frame,
     random and edge planes, 8 and 10 bits, three QPs; also at 144x80,
     where the last thread block holds one tile, and at 1920x1088, random,
     checkerboard, all-max and the clip's planes, qp_scaled 0, 22, 37 and
     the largest; timed at 1920x1088 too), K7 frame_inter (one
     reference, every inter class of the dense search; its tile pass alone
     against the plain tile SSD maps), K6 rd_cost_pred on K7's
     predictions and at every (w, h) in {4..64}^2 (8 and 10 bits, quant
     rounding 85 and 171, the frame's blocks and the all-max residual,
     one, 37 and every block), K8 leaf_qpel (the frame's 16x16, 32x32 and 64x64 blocks
     as leaves of 4, 16 and 64 tiles, and the 64x64 leaves at the largest
     10-bit residual; its tile pass alone against the plain per-tile
     SATDs): all outputs equal, tolerance 0. K7 and K8 are split by pass on
     the graph (the C entry with no class or no leaf runs the tile pass
     alone), and K7's tile pass is timed beside the reference's own
     formulation as a float32 PyTorch chain (grouped conv2d, conv2d, b^2,
     b^2 - 2 corr + r^2; its largest difference from the kernel's map
     printed): the row's library time;
     then the kernels of the all-intra tool paths at the same class shapes
     (frame, random and edge planes, 8 and 10 bits): K12a refs_blocks and
     K10 mip_preds at every class position, K3 satd67 and K4 rd_cost over
     the class's 12 or 16 MIP candidates, K11 mts_search (classes up to
     32x32) on K4's winning prediction and on the largest residual, and
     K10 and K11 (up to 32x32) at the BT/TT shapes too: all outputs equal,
     tolerance 0. K10, K11 and K12a are also timed per class on a CUDA
     graph of 20 calls (K10 and K12a through their C entries), beside
     their earlier designs' (K6 and K1 too);
  4c. the kernels of the per-class inter search and of the rough search at
     832x480 (frame, flat and edge planes, 8 and 10 bits): K9a
     fullpel_search and both forms of K9b frac_search (all 49 predictions;
     the winner's only, held against the plain gather) at the inter
     classes of the 10-bit LD path, also with the blocks in reverse
     order (and on all-max 10-bit planes at every class, 64x64 included),
     K2 over the 35 stage-1 modes, K12b predict_modes (the refine lists,
     random lists, and lists with repeated modes and modes outside [2, 66],
     which clamp), the K12c rough_refine chain and its two selection
     stages alone at every class of the rough path, and the two stages on
     crafted ties (rough_stage_cases: all SATDs equal, the minimum at each
     slot, i1 and i2 tied, refine slots tied with stage-1 slots, refine
     lists at 2 and 66; the real and flat mode bits; B = 1, 37 and 6240;
     stage 2 at each class's h*w on numbered predictions): all outputs
     equal, tolerance 0. K9a, both K9b forms, the K12c chain and its two
     stages are also timed on a CUDA graph of 20 calls, beside the earlier
     designs' times;
  4d. (run after phase 10: transform.cu and quant.cu build in a process of
     their own from phase 2 on, and no other phase launches them) the
     batched transforms and quantisers, whose only callers are their
     users (no encode path reaches them, as in the reference): K13
     fwd_transform / inv_transform and K14 quant_levels / dequant_levels
     at the four all-intra classes (DCT2, 8 and 10 bits), every MTS pair up
     to 32x32 and the rectangular 32x8 and 8x32, on the frame's residuals,
     random residuals, int16-range inputs and the int32 extremes (random
     int32, a checkerboard of INT32_MAX and INT32_MIN), the quantisers at
     qp_scaled 0, 22, 27, 37 and the largest, on the int32 wrap edges, on
     K13's int16 coefficients as they are and on int16 and int32 views at
     an element offset of 1, 2 and 4; K13 also at every (w, h) in
     {4..64}^2 and at the generic shapes (a dimension of 1 or 2, 10 bits),
     K14 on 86-element tensors (not a multiple of 8): all outputs equal,
     dtypes included, tolerance 0. K13 also against the same
     function as two float64 torch.matmul calls and the steps between them
     (its "library" time, a chain of calls), equal on the frame's inputs;
     all four timed on a CUDA graph too, beside their first designs'.
     Then the slice's own path: a round trip of the frame's residuals
     through fwd_batch, quant_batch, dequant_batch and inv_batch per class,
     one launch of each kernel per class, the output equal to the numpy
     host functions on sampled blocks, and its device busy time;
  5. the all-intra path: Encoder(cfg, device="cuda").feed/flush of a
     10-frame 832x480 all-intra QP22 clip (bench.py's configuration); K1-K4
     must launch once per size class and frame, every other kernel never
     (on every encode path K13 and K14 must launch zero times);
     wall fps and device busy time;
  6. the low-delay path: bench.py's LD configuration (832x480 QP27, GOP 4
     low-delay, rdoq off) over its 40-frame sequence: host ME, K5 and K1-K4
     per P frame (the intra screen); the launch counts must match the size
     classes and slice types; wall fps and device busy time;
  6b. the low-delay path with rdoq on (phase 6's configuration with the
     Config default, as the medium preset sets it), 5 frames: host ME, K5
     and K1-K4 as in phase 6, K8 once per P/B frame with inter leaves;
     wall fps and device busy time split over every kernel;
  7. the dense inter path: ime_algorithm=2, rdoq on, random-access GOP 8,
     9 frames at 832x480: K1-K4 per frame, K7 per reference, K6 per
     reference and inter class, K8 per frame with inter leaves; wall fps
     and device busy time split over every kernel;
  7b. the MIP path: the all-intra configuration with mip=True, 3 frames at
     832x480, every class through dispatch_blocks: per class and frame K1
     and K2 once, K3 and K4 twice (67 modes, then the MIP candidates), K10
     and K12a once; the MTS path: the same with mts=1, every class through
     search_blocks: K2, K3, K4 once per class and frame, K11 once per class
     up to 32x32, K1 never (the references are built on the host); wall fps
     and device busy time of both;
  7c. the per-class paths, each through Encoder.feed/flush at 832x480 with
     its launch counts: the 10-bit LD path (the LD configuration at 10
     bits, 5 frames: every device inter path declines, so each P/B frame
     runs search_combined per class: K2, K3, K4 per class, K9a, K9b and K6
     per inter class and unique reference, K6 once more per inter class of
     a B slice); the slow-tools RA path (RA GOP 8 with bipred, two
     references, MTS 3 and MIP, as the slower preset pairs them, 9 frames:
     search_combined with K11 per class up to 32x32 and the bipred
     candidate); the rough path (the all-intra configuration with
     intra_rough, 3 frames: per class K12a, K2 at 35 modes, K3 twice,
     K12b, the two K12c selections and K6); wall fps and device busy time
     of each, split over every kernel with its launch count;
  8. the card against the CPU (plain versions): all-intra frame 0, the
     first three LD frames (I, P, P), the first two rdoq LD frames (I, P),
     a three-frame clip of the dense path
     (I, P, B), frame 0 of the MIP and MTS paths, the first two frames of
     the 10-bit LD path (I, P), a three-frame clip of the slow-tools RA
     path (I, P, B), frame 0 of the rough path and a three-frame LD clip at
     136x72 (its plane pads to 144x80: K5's last thread block holds one
     tile, the last CTU row is partial) must give byte-identical access
     units and recon;
  9. the mesh encoders, the CLI and the entry points on the card:
  9a. MeshEncoder on a ('gop', 'tile') = (2, 4) mesh: 832x480 all-intra
     QP22 with 2x2 tiles (wpp off), 4 frames of the clip; its AUs and
     recons byte-identical to the plain Encoder's on the card with the same
     Config, its per-frame RD stats > 0, K1-K4 once per class and batch of
     2 frames (the plain encode once per class and frame); then the same
     with mip=True over 2 frames (K10 once per class and frame, K2 once and
     K3/K4 twice per class and batch); wall fps and device busy time;
  9b. MeshGopEncoder on a ('gop',) mesh of 2: phase 6's LD configuration
     (QP27, intra_period 64, wpp off), 2 runs of 4 frames, byte-identical
     to two plain Encoders; every step through the batched group dispatch
     (one call a step, no fallback), K1-K4 once per class and step, K5 once
     per P step; wall fps and device busy time; the wall of the same 8
     frames through the gop mesh, the gop mesh with its dispatcher unset
     and two plain Encoders, in the order a b c c b a; then the batched
     call alone at 832x480 with G = 2 slots at one QP and at two, for the
     P/B screen (K5 per group) and the IDR search: each row equal to the
     slot's own call on the card and to the plain versions on the CPU,
     tolerance 0, K1-K3 once per class and K4 (and K5) once per QP group;
  9c. the CLI (python -m uvg266_tpu_torch.tools.encode --device cuda
     --verify) in a subprocess on a 3-frame 832x480 .y4m of the clip: its
     output file equals the port Encoder's AUs on the card, and decodes
     through the port's oracle (ref_decoder) with every checksum right;
  9d. graft_entry.entry() on the card equal to its plain form (device
     cpu), tolerance 0, and graft_entry.dryrun_multichip(8, device=cuda)
     (every shard batched on the card);
 10. 192x128 clips encoded on the card (all-intra, LD, rdoq LD, dense RA,
     MIP, MTS, 10-bit LD, slow-tools RA, rough) decode through the port's oracle
     decoder, with their references, to the encoder's reconstruction;
 11. the presets and the host tools, each encode on the card held against
     the port's CPU path (the kernels' plain versions) frame by frame:
     access units byte-identical, recon planes equal (SHA-256 of their
     bytes). The CPU half runs in one child process started before phase
     2, on the cores the build and the card's phases leave idle;
  11a. every preset (make_config(preset) at 832x480, the clip's first
     frames, low delay at the preset's GOP: 3 frames for ultrafast..slow,
     2 for slower..placebo): wall fps, device busy time over a second
     encode (slower..placebo: one encode under the profiler gives both),
     the launches of every kernel, held to the path's counts (the
     fused search and the host-ME screen: K1-K4 once per class and frame,
     the BT/TT classes under slow, K5 per P frame, K8 per P frame with
     inter leaves; with MTS, slower..placebo, search_blocks and
     search_combined per class, K11 up to 32x32, K9a/K9b/K6 per inter
     class and reference);
  11b. the host tools no preset turns on (ALF 2 all-intra and ALF 1 LD,
     2x2 tiles all-intra and LD, 2 slices, LMCS all-intra and LD, IBC,
     transform skip, the default scaling lists, rate control (R-lambda
     and OBA), VAQ, AMVR with TMVP, RA GOP 8, 4:0:0), 3 frames at 136x72
     each, with the same launch checks;
  11c. the Config defaults (LD GOP 4, rdoq on) at 72x40: the 64x64 class
     has no position and is skipped; every wrapper refuses an empty batch,
     so the encode shows that none was asked for one;
 12. the reference's 1920x1080 configurations (BDRATE_1080p.json: the port's
     tools/bdrate.py synth_clip, seed 7) and a 3840x2160 batch, each frame
     held to tests/vectors/torch_ctc_digests.json (tools/ctc_digests.py:
     the port's CPU path and the JAX package's, per frame): all-intra QP22
     and QP37, low delay QP22 and RA GOP 8 QP27 (the CLI's -p 1, --gop lp
     and --gop ra8 with --preset ultrafast) through Encoder.feed/flush,
     low delay QP37 through the CLI in a subprocess (its output file and
     --rec-out), the Config default (make_config(): LD GOP 4, rdoq on)
     and phase 7c's 10-bit LD at QP27, and bench.py's all-intra Config at
     3840x2160 and 10 bits as one dispatch_frames_search batch of 3 frames,
     then encode_frame(prefetch=...). First K1-K4 at that batch's 64x64
     and 8x8 classes against their plain versions (K2's output 77.6% of
     2^31 elements), tolerance 0; then each encode with its wall fps,
     device busy share (one encode under the profiler gives both), peak
     device memory (max_memory_allocated) and launches held to the path's
     counts; the batch's largest element offset per wrapper beside 2^31;
     K1-K6, K8, K9a and K9b replayed from a CUDA graph on the calls of one
     encode each (device ms, launches and bound a 1080p frame); and the
     CPU child's all-intra QP22 and first two low-delay QP22 frames
     against the fixture (a host difference between machines told apart
     from a kernel fault). Phases 6b-7c time one encode under the
     profiler, which gives both the wall and the busy share;
 14. (run before phase 13) the meshes with one launch set a shard
     (parallel.mesh, devices=[...]), first on four streams of card 0
     (["cuda:0"] * 4), then spread over the first 4 (or 2) cards where the
     machine has them (it prints torch.cuda.device_count()), every frame
     byte-identical to the plain Encoder's on card 0: 14a MeshEncoder on a
     (gop 1, tile 4) mesh, phase 12's all-intra QP22 at 1920x1080 with 2x2
     tiles and wpp off (K1-K4 once per class and tile shard); 14b
     MeshGopEncoder, closed-GOP runs of 2 frames, each run a launch set on
     its card: phase 12's LD QP22 (wpp off) over four runs of distinct
     frames, the Config default (rdoq on: K8 on each run's card; two runs)
     and the 10-bit LD (K9a, K9b, K6 and their shared-memory opt-ins on
     each card; four runs), each run of these two on phase 12's two frames
     and held to its fixture too; every step batched, no fallback, the
     launches those of the runs' own encodes; each layout's wall fps
     beside the plain Encoder's, each card's busy share and peak memory,
     the launches by card; 14c the (gop 4, tile 1) mesh batched on card 0
     at 3840x2160 10 bits, 4 frames in one search (K2's output 2.22e9
     elements, past 2^31), its frames equal to the plain Encoder's, each
     wrapper's largest element offset beside 2^31.
     `python3 chip_smoke.py --mesh-cards` runs phases 1, 2 and 14 alone
     (for a machine with several cards);
 13. a JSON line with each kernel's numbers (at_1920x1080: phase 12's),
     then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

W, H, FRAMES, QP = 832, 480, 10, 22
LD_FRAMES, LD_QP = 40, 27          # bench.py:63, :77
RA_FRAMES = 9                      # IDR + one random-access GOP of 8
TOOL_FRAMES = 3                    # the MIP and MTS paths (Python finalize)
LD10_FRAMES = 5                    # the 10-bit LD path: IDR + 4 P/B
RDOQ_FRAMES = 5                    # the rdoq-on LD path: IDR + 4 P/B
ROUGH_FRAMES = 3                   # the rough all-intra path
# phase 14: the 1080p tiled all-intra frames of the (gop 1, tile 4) mesh,
# and each of the gop mesh's four runs
MESH14_AI, MESH14_LD = 1, 2
# phase 11a: each preset's LD frames (slower..placebo run the Python
# finalize with every intra tool: 2 frames)
SLOW_PRESETS = ("slower", "veryslow", "placebo")
PRESET_FRAMES, SLOW_PRESET_FRAMES = 3, 2
TOOL_W, TOOL_H, TOOL_CLIP = 136, 72, 3     # phase 11b
SMALL_W, SMALL_H = 72, 40          # phase 11c: no 64x64 block inside
# the CPU half (phases 8, 11 and 12): child processes, intra-op threads
# each, on the cores the build and the card's phases leave idle
CHILD_PROCS, CHILD_THREADS = 3, 2
AI = {"gop_len": 0, "intra_period": 1}
# phase 11b: the host tools no preset turns on
# (tests/test_torch_e2e_host_tools.py), the other options at the Config
# defaults (low delay GOP 4, rdoq on, WPP on); 4:0:0 is input_format 0
HOST_TOOLS = {
    "alf2 all-intra": {**AI, "alf_type": 2},
    "alf1 LD": {"alf_type": 1},
    "tiles 2x2 all-intra": {**AI, "tiles_width_count": 2,
                            "tiles_height_count": 2},
    "tiles 2x2 LD": {"tiles_width_count": 2, "tiles_height_count": 2},
    "slices 2": {"slices": 2},
    "LMCS all-intra": {**AI, "lmcs_enable": True},
    "LMCS LD": {"lmcs_enable": True},
    "IBC": {"ibc": 1},
    "transform skip": {"trskip_enable": True},
    "scaling list 2": {"scaling_list": 2},
    "RC lambda": {"target_bitrate": 200000, "rc_algorithm": "lambda"},
    "RC OBA": {"target_bitrate": 200000, "rc_algorithm": "oba"},
    "VAQ": {"vaq": 1},
    "AMVR TMVP": {"amvr": 1, "tmvp_enable": True},
    "RA GOP 8": {"gop_len": 8, "gop_lowdelay": False},
    "4:0:0": {"input_format": 0},
}
# phase 12: the reference's 1920x1080 record (BDRATE_1080p.json: the port's
# tools/bdrate.py synth_clip, seed 7, and its CONFIGS, as the port's CLI
# builds them), the Config default, phase 7c's 10-bit LD, and bench.py's
# all-intra Config at 3840x2160 and 10 bits as one batch of 3 frames
# (dispatch_frames_search, then encode_frame(prefetch=...)); each frame's
# digests are in CTC_FIXTURE (tools/ctc_digests.py computes them with the
# port's CPU path and the JAX package)
CTC_FIXTURE = os.path.join("tests", "vectors", "torch_ctc_digests.json")
CTC = {   # label: (configuration, qp, frames, entry point, width, height)
    "1080p allintra q22": ("allintra", 22, 3, "encoder", 1920, 1080),
    "1080p allintra q37": ("allintra", 37, 3, "encoder", 1920, 1080),
    "1080p lowdelay q22": ("lowdelay", 22, 3, "encoder", 1920, 1080),
    "1080p lowdelay q37": ("lowdelay", 37, 3, "cli", 1920, 1080),
    "1080p ra8 q27": ("ra8", 27, 9, "encoder", 1920, 1080),
    "1080p default q27": ("default", 27, 2, "encoder", 1920, 1080),
    "1080p ld10 q27": ("ld10", 27, 2, "encoder", 1920, 1080),
    "2160p ai10 q22": ("ai10", 22, 3, "batch", 3840, 2160),
}
# phase 12's CLI row: python -m uvg266_tpu_torch.tools.encode with its
# arguments, run as -m runs it, then the launches its kernels made
CLI_WITH_LAUNCHES = (
    "import json, runpy\n"
    "from uvg266_tpu_torch import kernels\n"
    "try:\n"
    "    runpy.run_module('uvg266_tpu_torch.tools.encode', "
    "run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    print('LAUNCHES ' + json.dumps(kernels.LAUNCHES), flush=True)\n")
# the CPU child's phase-12 encodes (label, frames): the card's host
# differs from the fixture's, so these tell a host difference from a
# kernel fault
CTC_CPU = (("1080p allintra q22", 3), ("1080p lowdelay q22", 2))
R = 16                             # full-pel search range of the dense path
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
OPS_PER_S = 67e12             # H100 SXM float32 rate outside the tensor cores,
                              # the table's entry nearest to int32 ALU work
REPLACES = {
    "refs_blocks_grid": "uvg266_tpu/ops/intra_batch.py:619",
    "predict67": "uvg266_tpu/ops/intra_batch.py:420",
    "satd67": "uvg266_tpu/ops/intra_batch.py:521",
    "rd_cost": "uvg266_tpu/ops/rd_cost.py:78",
    "pseudo_recon": "uvg266_tpu/ops/pseudo_recon.py:80",
    "rd_cost_pred": "uvg266_tpu/ops/rd_cost.py:24",
    "frame_inter": "uvg266_tpu/ops/me_frame.py:159",
    "leaf_qpel": "uvg266_tpu/ops/me_frame.py:215",
    "mip_preds": "uvg266_tpu/ops/mip.py:108",
    "mts_search": "uvg266_tpu/ops/rd_cost.py:230",
    "refs_blocks": "uvg266_tpu/ops/intra_batch.py:552",
    "fullpel_search": "uvg266_tpu/ops/me.py:40",
    "frac_search": "uvg266_tpu/ops/me.py:79",
    "predict_modes": "uvg266_tpu/ops/intra_batch.py:374",
    "rough_refine": "uvg266_tpu/ops/rd_cost.py:154",
    "fwd_transform": "uvg266_tpu/ops/transforms.py:86",
    "inv_transform": "uvg266_tpu/ops/transforms.py:112",
    "quant_levels": "uvg266_tpu/ops/quant.py:153",
    "dequant_levels": "uvg266_tpu/ops/quant.py:174",
}
INTRA_KERNELS = ("refs_blocks_grid", "predict67", "satd67", "rd_cost")
# the kernels timed on a CUDA graph too (their wrappers only allocate their
# outputs and launch; K10's and K12a's C entries are graphed, since their
# wrappers copy the positions from the host)
GRAPH_KERNELS = INTRA_KERNELS + ("fullpel_search", "frac_search", "mip_preds",
                                 "mts_search", "frame_inter", "leaf_qpel",
                                 "rd_cost_pred", "refs_blocks",
                                 "predict_modes", "pseudo_recon",
                                 "rough_refine", "fwd_transform",
                                 "inv_transform", "quant_levels",
                                 "dequant_levels")
TR_KERNELS = ("fwd_transform", "inv_transform", "quant_levels",
              "dequant_levels")
TR_QPS = (0, 22, 27, 37)      # qp_scaled of phase 4d, and the largest
# the BT/TT child shapes of the lattice K2 and K4 are also held at (phase 3)
LATTICE_SHAPES = ((32, 8), (8, 32), (64, 16), (16, 64), (4, 16), (16, 4))
# the earlier designs' per-class times, printed beside the new ones, ms per
# 832x480 frame on an NVIDIA H100 80GB HBM3 at 700.00 W: K2 (per-sample
# tables) and K4 (full matrix products) by CUDA events; K10 (a thread block
# per block, runtime divisions) and K11 (the five pairs one after another
# through full matrix products) on a CUDA graph (tools/k10_k11_times.py);
# K6, K1 and K12a as noted below
EARLIER_MS = {("predict67", 64): 0.1222, ("predict67", 32): 0.1266,
              ("predict67", 16): 0.1241, ("predict67", 8): 0.1336,
              ("rd_cost", 64): 0.1355, ("rd_cost", 32): 0.0367,
              ("rd_cost", 16): 0.0506, ("rd_cost", 8): 0.0529,
              ("mip_preds", 64): 0.0714, ("mip_preds", 32): 0.0430,
              ("mip_preds", 16): 0.0478, ("mip_preds", 8): 0.0718,
              ("mts_search", 32): 0.1347, ("mts_search", 16): 0.0627,
              ("mts_search", 8): 0.1234,
              # K6 (256 threads a block, a full matrix product per output)
              # per dense reference; K1 and K12a (a thread per output
              # sample, K12a through its C entry) per frame: on a CUDA graph
              # (tools/k6_k1_times.py on the tree before their redesign)
              ("rd_cost_pred", 32): 0.0285, ("rd_cost_pred", 16): 0.0138,
              ("rd_cost_pred", 8): 0.0192,
              ("refs_blocks_grid", 64): 0.0052,
              ("refs_blocks_grid", 32): 0.0070,
              ("refs_blocks_grid", 16): 0.0133,
              ("refs_blocks_grid", 8): 0.0362,
              ("refs_blocks", 64): 0.0044, ("refs_blocks", 32): 0.0059,
              ("refs_blocks", 16): 0.0107, ("refs_blocks", 8): 0.0277,
              # K12b (a thread block per block, the per-sample tables) per
              # rough class on K12c stage 1's refine lists, and K5 (a thread
              # block per tile, 16-term products) at 832x480 (w = 16: its
              # tiles): on a CUDA graph (tools/k12b_k5_times.py on the tree
              # before their redesign)
              ("predict_modes", 64): 0.0246, ("predict_modes", 32): 0.0101,
              ("predict_modes", 16): 0.0096, ("predict_modes", 8): 0.0143,
              ("pseudo_recon", 16): 0.0099,
              # K13 and K14 as first written (a thread block of 256 per
              # transform block, plain products, int32 intermediates; a
              # thread per element, int32 only: the wrapper converted K13's
              # int16 coefficients first) per all-intra class on the
              # frame's residuals, the wrappers on a CUDA graph
              # (tools/k12c_times.py on the tree before their redesign)
              ("fwd_transform", 64): 0.0268, ("fwd_transform", 32): 0.0115,
              ("fwd_transform", 16): 0.0082, ("fwd_transform", 8): 0.0067,
              ("inv_transform", 64): 0.0336, ("inv_transform", 32): 0.0115,
              ("inv_transform", 16): 0.0079, ("inv_transform", 8): 0.0065,
              ("quant_levels", 64): 0.0050, ("quant_levels", 32): 0.0050,
              ("quant_levels", 16): 0.0051, ("quant_levels", 8): 0.0051,
              ("dequant_levels", 64): 0.0028,
              ("dequant_levels", 32): 0.0028,
              ("dequant_levels", 16): 0.0028,
              ("dequant_levels", 8): 0.0028}
# K5 before its redesign at 1920x1088, 8 bits, as above
K5_BEFORE_MS = {"1920x1088": 0.0452}
# K12c's selection stages before their redesign (a thread a block; a thread
# block a block whose first thread scans the costs), device ms a rough
# 832x480 frame on a CUDA graph, tools/k12b_k5_times.py on an NVIDIA H100
# 80GB HBM3 at 700.00 W
K12C_BEFORE_MS = {"rough_select": 0.0222, "rough_pick": 0.0443}
# K9a and K9b before their redesign (a thread per offset; a thread block
# per block and offset), ms per reference at 10 bits (16x16 + 8x8), CUDA
# events, this script on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md)
K9_BEFORE_MS = {"fullpel_search": 0.2907, "frac_search": 1.0524}
# K7 and K8 before their redesign (a thread block per tile, one thread per
# offset or per sample), device ms on a CUDA graph by pass, phase 4's
# inputs, tools/k7_k8_times.py on an NVIDIA H100 80GB HBM3 at 700.00 W
K78_BEFORE_MS = {("frame_inter", "whole"): 0.1978,
                 ("frame_inter", "tile"): 0.1201,
                 ("leaf_qpel 16x16", "whole"): 0.3861,
                 ("leaf_qpel 16x16", "tile"): 0.3809,
                 ("leaf_qpel 64x64", "whole"): 0.3838,
                 ("leaf_qpel 64x64", "tile"): 0.3636}
# the path whose run gives each kernel's "launches" in the JSON line
MAIN_PATH = {**dict.fromkeys(INTRA_KERNELS, "all-intra"),
             "pseudo_recon": "low-delay", "rd_cost_pred": "dense RA",
             "frame_inter": "dense RA", "leaf_qpel": "rdoq LD",
             "mip_preds": "MIP", "refs_blocks": "MIP", "mts_search": "MTS",
             "fullpel_search": "10-bit LD", "frac_search": "10-bit LD",
             "predict_modes": "rough", "rough_refine": "rough",
             **dict.fromkeys(TR_KERNELS, "transform round trip")}


# the child processes started here (the CPU half's pool, the late build),
# stopped on failure
_CHILDREN: list = []
# the sources only phase 4d needs (K13, K14): built in a process of their
# own while phases 3-4c run (transform.cu alone takes minutes of nvcc)
LATE_SOURCES = ("transform", "quant")
LATE_BUILD = ("from uvg266_tpu_torch import kernels; "
              f"kernels.build({LATE_SOURCES!r})")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    for child in _CHILDREN:
        child.terminate()
        if hasattr(child, "join"):
            child.join()
        else:
            child.wait()
    sys.exit(1)


def synth_clip(w=W, h=H, frames=FRAMES):
    """bench.py's synthetic clip (seed 7), at any size."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(frames):
        y = (xx * 0.3 + yy * 0.2 + 40 * np.sin((xx + 3 * t) / 16.0)
             + 30 * np.cos((yy - 2 * t) / 11.0)
             + 20 * ((xx // 32 + yy // 32 + t) % 2))
        y = np.clip(y + rng.integers(-6, 6, (h, w)), 0, 255).astype(np.int32)
        u = np.clip(128 + 20 * np.sin((xx[::2, ::2] + 5 * t) / 24.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255).astype(np.int32)
        v = np.clip(128 + 20 * np.cos((yy[::2, ::2] + 4 * t) / 21.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255).astype(np.int32)
        out.append((y, u, v))
    return out


def bench_config(Config, w=W, h=H):
    return Config(width=w, height=h, qp=QP, gop_len=0, intra_period=1,
                  sao_type=3, alf_type=0, deblock_enable=True,
                  rdoq_enable=False, signhide_enable=True, dep_quant=False,
                  wpp=False)


def ld_config(Config, w=W, h=H):
    """bench.py:77-80, the low-delay benchmark (lp-g4d3t1 QP27)."""
    return Config(width=w, height=h, qp=LD_QP, gop_len=4, gop_lowdelay=True,
                  intra_period=64, sao_type=0, alf_type=0,
                  deblock_enable=True, rdoq_enable=False,
                  signhide_enable=False, dep_quant=False, wpp=False)


def rdoq_ld_config(Config, w=W, h=H):
    """The low-delay configuration with rdoq on (the Config default and the
    medium preset's setting): the host-ME path refines its inter leaves in
    K8 on every P/B frame."""
    return dataclasses.replace(ld_config(Config, w, h), rdoq_enable=True)


def mip_config(Config, w=W, h=H):
    """The all-intra benchmark configuration with MIP on."""
    return dataclasses.replace(bench_config(Config, w, h), mip=True)


def mts_config(Config, w=W, h=H):
    """The all-intra benchmark configuration with intra MTS on."""
    return dataclasses.replace(bench_config(Config, w, h), mts=1)


def ld10_config(Config, w=W, h=H):
    """The low-delay benchmark configuration at 10 bits (Main 10)."""
    return dataclasses.replace(ld_config(Config, w, h), input_bitdepth=10)


def slow_ra_config(Config, w=W, h=H):
    """Random access, GOP 8, with the tools the slower presets pair
    (uvg266_tpu/cfg.py:229-248): bipred, two references, MTS 3 and MIP;
    rdoq on (the Config default)."""
    return Config(width=w, height=h, qp=LD_QP, gop_len=8, gop_lowdelay=False,
                  bipred=1, ref_frames=2, mts=3, mip=True)


def rough_config(Config, w=W, h=H):
    """The all-intra benchmark configuration with the rough intra search."""
    return dataclasses.replace(bench_config(Config, w, h), intra_rough=True)


def clip_for(cfg, clip):
    """An 8-bit clip of (y, u, v) planes at the configuration's bit depth."""
    sc = 1 << (cfg.input_bitdepth - 8)
    return [tuple(p * sc for p in f) for f in clip]


def search_classes(ps):
    """(w, h, positions) of every class PartitionSearch.search gives its
    per-class function: the lattice shapes, then the TT middle children,
    each with a block inside the frame."""
    return [(w, h, pos) for (_k, w, h, pos, _s) in ps._classes() if pos]


def job_config(Config, make_config, opts, w, h):
    """A CPU-half configuration: a preset's name, one of the *_config
    functions above, or Config options."""
    if isinstance(opts, str):
        return make_config(opts, width=w, height=h)
    if callable(opts):
        return opts(Config, w, h)
    return Config(width=w, height=h, **opts)


def job_clip(cfg, n):
    """The clip's first n frames at cfg's size and bit depth (luma only at
    4:0:0)."""
    frames = clip_for(cfg, synth_clip(cfg.width, cfg.height, n))
    if cfg.input_format == 0:
        frames = [(f[0], None, None) for f in frames]
    return frames


def phase8_jobs():
    """(label, configuration, width, height, frames) of every CPU encode
    of phase 8: each path's first frames."""
    return [("all-intra", bench_config, W, H, 1),
            ("low-delay", ld_config, W, H, 3),
            ("rdoq LD", rdoq_ld_config, W, H, 2),
            ("dense RA", dense_config, W, H, 3),
            ("MIP", mip_config, W, H, 1), ("MTS", mts_config, W, H, 1),
            ("10-bit LD", ld10_config, W, H, 2),
            ("slow RA", slow_ra_config, W, H, 3),
            ("rough", rough_config, W, H, 1),
            ("LD 136x72", ld_config, 136, 72, 3)]


def phase11_jobs(presets):
    """(label, preset or options, width, height, frames) of every encode of
    phase 11."""
    jobs = [(f"preset {p}", p, W, H,
             SLOW_PRESET_FRAMES if p in SLOW_PRESETS else PRESET_FRAMES)
            for p in presets]
    jobs += [(f"host tool {k}", v, TOOL_W, TOOL_H, TOOL_CLIP)
             for k, v in HOST_TOOLS.items()]
    jobs.append((f"LD {SMALL_W}x{SMALL_H}", {}, SMALL_W, SMALL_H, 3))
    return jobs


def recon_digest(rec) -> str:
    """SHA-256 of a recon's planes with their dtypes and shapes."""
    d = hashlib.sha256()
    for p in (rec.y, rec.u, rec.v):
        if p is None:
            d.update(b"none")
        else:
            d.update(f"{p.dtype}{p.shape}".encode())
            d.update(np.ascontiguousarray(p).tobytes())
    return d.hexdigest()


def cpu_encodes(jobs):
    """The port's CPU path (the kernels' plain versions) for every job:
    {label: [(access unit, recon digest) per frame]} and the seconds it
    took. Runs in a child process while the card's phases run."""
    import torch
    torch.set_num_threads(CHILD_THREADS)
    from uvg266_tpu_torch.cfg import Config, make_config
    from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes
    t0 = time.perf_counter()
    out = {}
    for label, opts, w, h, n in jobs:
        cfg = job_config(Config, make_config, opts, w, h)
        got = encode(Encoder(cfg, device="cpu"), FramePlanes,
                     job_clip(cfg, n))
        out[label] = [(o[0], recon_digest(o[1])) for o in got]
    return out, time.perf_counter() - t0


def ctc_config(label, w=None, h=None):
    """The port's Config of phase-12 encode ``label`` (at w x h if given):
    the CLI's for tools/bdrate.py's configurations, make_config()'s
    default, phase 7c's 10-bit LD, bench.py's all-intra at 10 bits."""
    from uvg266_tpu_torch.cfg import Config, make_config
    from uvg266_tpu_torch.tools.bdrate import CONFIGS
    from uvg266_tpu_torch.tools.encode import cli_config
    name, qp, _n, _entry, w0, h0 = CTC[label]
    w, h = w or w0, h or h0
    if name in CONFIGS:
        return cli_config(CONFIGS[name][1] + ["-q", str(qp)], w, h)
    if name == "default":
        return make_config(width=w, height=h, qp=qp)
    if name == "ld10":
        return dataclasses.replace(ld10_config(Config, w, h), qp=qp)
    return dataclasses.replace(bench_config(Config, w, h), qp=qp,
                               input_bitdepth=10)


def ctc_clip(w, h, n, bitdepth=8):
    """tools/bdrate.py's synth_clip (seed 7) as int32 planes at
    ``bitdepth`` (shifted left by bitdepth - 8)."""
    from uvg266_tpu_torch.tools.bdrate import synth_clip as bd_clip
    return [tuple(p.astype(np.int32) << (bitdepth - 8) for p in f)
            for f in bd_clip(w, h, n, seed=7)]


def port_api(device):
    """The port's classes for ctc_encode, on ``device``."""
    from uvg266_tpu_torch.control.encoder import (Encoder, FramePlanes,
                                                  SliceEncoder)
    from uvg266_tpu_torch.control.params import EncoderControl, FrameState
    return {"Encoder": lambda cfg: Encoder(cfg, device=device),
            "SliceEncoder": lambda cfg, ctrl: SliceEncoder(cfg, ctrl,
                                                           device=device),
            "FramePlanes": FramePlanes, "EncoderControl": EncoderControl,
            "FrameState": FrameState}


def ctc_encode(api, cfg, frames, entry, batch=None):
    """Encode ``frames`` with ``cfg`` through a package's entry point ->
    [(au, recon, slice type)] per frame. entry "encoder" (and "cli", whose
    frames the fixture takes from the Encoder): Encoder.feed/flush;
    "batch": SliceEncoder.dispatch_frames_search over ``batch`` frames at
    a time (default all), then encode_frame(prefetch=...), as bench.py:122-
    219 drives the reference."""
    if entry != "batch":
        return [(o[0], o[1], int(o[2].slicetype)) for o in
                encode(api["Encoder"](cfg), api["FramePlanes"], frames)]
    planes = [api["FramePlanes"](*f) for f in frames]
    FrameState = api["FrameState"]
    se = api["SliceEncoder"](cfg, api["EncoderControl"](cfg))
    batch = batch or len(planes)
    out = []
    for b0 in range(0, len(planes), batch):
        idx = range(b0, min(b0 + batch, len(planes)))
        pre = se.dispatch_frames_search(
            [FrameState(num=i, qp=cfg.qp) for i in idx],
            [planes[i] for i in idx])
        if pre is None:
            raise RuntimeError("dispatch_frames_search declined the batch")
        for j, i in enumerate(idx):
            au, rec = se.encode_frame(FrameState(num=i, qp=cfg.qp), planes[i],
                                      prefetch=pre[j])
            out.append((au, rec, 2))         # all-intra: every frame I
    return out


def rec_out_digest(rec, w, h, bitdepth) -> str:
    """SHA-256 of the bytes the CLI's --rec-out writes for a frame (the
    planes cropped to w x h, uint8 or little-endian uint16)."""
    dt = np.uint8 if bitdepth == 8 else np.dtype("<u2")
    d = hashlib.sha256()
    for p, (ph, pw) in ((rec.y, (h, w)), (rec.u, (h // 2, w // 2)),
                        (rec.v, (h // 2, w // 2))):
        if p is not None:
            d.update(p[:ph, :pw].astype(dt).tobytes())
    return d.hexdigest()


def frame_digests(outs, cfg):
    """Each frame's digests as the fixture holds them."""
    return [{"type": SLICE[t], "au": hashlib.sha256(au).hexdigest(),
             "au_bytes": len(au), "recon": recon_digest(rec),
             "rec_out": rec_out_digest(rec, cfg.width, cfg.height,
                                       cfg.input_bitdepth)}
            for au, rec, t in outs]


def ctc_cpu_encodes(jobs):
    """The port's CPU path for the phase-12 encodes ``jobs`` ((label,
    frames), the clip's first frames): {label: frame digests} and the
    seconds it took. Runs in the child process after cpu_encodes."""
    import torch
    torch.set_num_threads(CHILD_THREADS)
    t0 = time.perf_counter()
    out = {}
    for label, n in jobs:
        cfg = ctc_config(label)
        out[label] = frame_digests(ctc_encode(
            port_api("cpu"), cfg, ctc_clip(cfg.width, cfg.height, n,
                                           cfg.input_bitdepth),
            CTC[label][3]), cfg)
    return out, time.perf_counter() - t0


def dense_config(Config, w=W, h=H):
    """The all-device dense inter search (--me full), rdoq on (the Config
    default: leaf refinement in K8), random-access GOP 8."""
    return Config(width=w, height=h, qp=LD_QP, gop_len=8, gop_lowdelay=False,
                  ime_algorithm=2, rdoq_enable=True)


def time_ms(torch, fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def warm_up(torch, seconds: float = 0.5) -> None:
    """Keep the card busy for about ``seconds`` (float32 products), so that
    the times that follow are taken at its working clocks."""
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            x = x @ x
            x = x / x.abs().max()
        torch.cuda.synchronize()


def graph_ms(torch, fn, n: int, reps: int = 5) -> float:
    """Device time of one call: n calls captured in a CUDA graph and the
    graph replayed, so the host's launch path between calls is not timed
    (for wrappers that only allocate their outputs and launch)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (n * reps)
    del g
    return ms


def k7_inputs(torch, frames, dev):
    """Phase 4's K7 inputs: frame 1 (src) against frame 0 edge-padded by R,
    the rate penalty and bits table at QP27."""
    from uvg266_tpu_torch.control.partition import qp_to_lambda
    from uvg266_tpu_torch.ops import me_frame as mf
    from uvg266_tpu_torch.ops.me import make_mv_penalty
    cur = torch.from_numpy(frames[1][0]).to(dev)
    ref_pad = torch.from_numpy(
        np.pad(frames[0][0], R, mode="edge").astype(np.int32)).to(dev)
    lam = float(np.float32(qp_to_lambda(LD_QP, False)))
    pen = torch.from_numpy(make_mv_penalty(R, np.sqrt(lam)).reshape(-1)) \
        .to(dev)
    return cur, ref_pad, pen, torch.from_numpy(mf.mv_bits_table(R)).to(dev)


def k8_pen(torch, dev):
    """Phase 4's K8 penalty [49] at QP27: sqrt(lambda) * 2 per fractional
    component, as _refine_inter_leaves builds it."""
    from uvg266_tpu_torch.control.partition import qp_to_lambda
    lam = float(np.float32(qp_to_lambda(LD_QP, False)))
    return torch.from_numpy(np.array(
        [np.sqrt(lam) * ((0.0 if k % 7 == 3 else 2.0)
                         + (0.0 if k // 7 == 3 else 2.0))
         for k in range(49)], dtype=np.float32)).to(dev)


def k8_leaves(k7_32=None, w=W, h=H):
    """Phase 4's K8 leaves (x, y, size, mvx, mvy) by size: the frame's
    16x16 and 64x64 blocks at seeded random full-pel MVs, its 32x32 blocks
    at K7's 32x32 MVs (k7_32 = (grid, idx)) or at random ones."""
    rng = np.random.default_rng(3)
    nn = 2 * R + 1

    def random_mv():
        return tuple(int(v) for v in rng.integers(-8, 9, 2))
    out = {16: [(x, y, 16, *random_mv()) for y in range(0, h, 16)
                for x in range(0, w, 16)]}
    if k7_32 is not None:
        (x0, y0, sx, sy, gx, _gy), idx = k7_32
        out[32] = [(x0 + (b % gx) * sx, y0 + (b // gx) * sy, 32,
                    int(k) % nn - R, int(k) // nn - R)
                   for b, k in enumerate(idx.tolist())]
    else:
        out[32] = [(x, y, 32, *random_mv()) for y in range(0, h - 31, 32)
                   for x in range(0, w - 31, 32)]
    out[64] = [(x, y, 64, *random_mv()) for y in range(0, h - 63, 64)
               for x in range(0, w - 63, 64)]
    return out


def k8_tiles(torch, leaves, ref0, src1, dev):
    """[windows [nt, 18, 18], blocks [nt, 8, 8], leaf ids [nt], n_leaves]
    of leaves cut as _refine_inter_leaves cuts them."""
    from uvg266_tpu_torch.ops.inter import fetch_extended_block
    tiles, tblocks, ids = [], [], []
    for li, (x, y, s, mvx, mvy) in enumerate(leaves):
        win = fetch_extended_block(ref0, x + mvx, y + mvy, s, s, 5, 5, 5, 5)
        for i in range(s // 8):
            for j in range(s // 8):
                tiles.append(win[8 * i:8 * i + 18, 8 * j:8 * j + 18])
                tblocks.append(src1[y + 8 * i:y + 8 * i + 8,
                                    x + 8 * j:x + 8 * j + 8])
                ids.append(li)
    return [torch.from_numpy(np.stack(a).astype(np.int32)).to(dev)
            for a in (tiles, tblocks, ids)] + [len(leaves)]


def k7_tile_pass(kernels, src, ref_pad, r, pen, bits_tab, ssd):
    """K7's C entry with no class: its tile pass alone, into ssd
    [(H/8)*(W/8), (2r+1)^2] int32."""
    H, W = src.shape
    kernels.launch("frame_inter", src.device, src.data_ptr(),
                   ref_pad.data_ptr(), H, W, r, pen.data_ptr(),
                   bits_tab.data_ptr(), None, 0, ssd.data_ptr(), None, None,
                   None, None)


def k8_tile_pass(kernels, wins, blks, ids, pen, bd, satd):
    """K8's C entry with no leaf: its tile pass alone, into satd [nt, 49]
    int32."""
    kernels.launch("leaf_qpel", wins.device, wins.data_ptr(), blks.data_ptr(),
                   ids.data_ptr(), wins.shape[0], 0, pen.data_ptr(), bd,
                   satd.data_ptr(), None, None, None)


def k7_library(torch, src, ref_pad, r):
    """K7's tile pass as the reference formulates it (me_frame.py
    tile_ssd_maps), as a PyTorch chain in float32 with TF32 off: a grouped
    conv2d of the tiles' (8+2r)^2 windows with the source tiles (corr), a
    conv2d of the squared windows with an 8x8 ones kernel (r^2), b^2, and
    b^2 - 2 corr + r^2. Returns the chain (-> [T, 2r+1, 2r+1] float32);
    the windows are cut once, outside it."""
    F = torch.nn.functional
    H, W = src.shape
    side, T = 8 + 2 * r, (H // 8) * (W // 8)
    win = ref_pad.float().unfold(0, side, 8).unfold(1, side, 8) \
        .reshape(T, side, side).contiguous()
    tiles = src.float().reshape(H // 8, 8, W // 8, 8).permute(0, 2, 1, 3) \
        .reshape(T, 1, 8, 8).contiguous()
    ones = torch.ones((1, 1, 8, 8), device=src.device)

    def chain():
        corr = F.conv2d(win[None], tiles, groups=T)[0]
        r2 = F.conv2d((win * win)[:, None], ones)[:, 0]
        b2 = (tiles * tiles).sum(dim=(-2, -1))
        return b2[..., None] - 2.0 * corr + r2
    return chain


def dct_ops(n: int) -> int:
    """Operations of one n-point integer DCT-II as a partial butterfly
    (the form VVC's integer matrices allow): n adds/subtracts, the odd
    half as an (n/2)x(n/2) multiply-add, the even half recursively."""
    return 4 if n <= 2 else n + 2 * (n // 2) ** 2 + dct_ops(n // 2)


def satd_ops(n: int) -> int:
    """Operations per sample of an n x n Hadamard SATD: the difference,
    log2(n) butterfly adds per pass and direction, abs and the sum."""
    return 1 + 2 * (n.bit_length() - 1) + 2


def joint_ops(n: int, k: int) -> int:
    """Operations of one n-point line's DST7 and DCT8 together, the first
    k outputs of each (DCT8[k][x] = (-1)^k DST7[k][n-1-x]): n adds and
    subtracts for v[x] +- v[n-1-x], two n/2-term multiply-adds per k, and
    the sum, the difference and their halving per k."""
    return n + k * (2 * n + 4)


def mts_ops(w: int, h: int, kw: int, kh: int) -> int:
    """Operations of the five MTS candidates' transforms: DCT2/DCT2
    forward and inverse as partial butterflies; the four DST7/DCT8 pairs'
    forward passes shared (one row pass gives both horizontal types, one
    column pass per horizontal type both vertical ones, kw x kh
    coefficients kept), and per pair the inverse as matrix products over
    the kept coefficients (no butterfly)."""
    dct2 = 2 * (h * dct_ops(w) + w * dct_ops(h))
    fwd = h * joint_ops(w, kw) + 2 * kw * joint_ops(h, kh)
    inv = 4 * (2 * kw * h * kh + 2 * h * w * kw)
    return dct2 + fwd + inv


def work(name, B, w, h, H_, W_, M=67, **kw):
    """(bytes, operations) the function must move/do for one call: each
    input read once, each output written once; a multiply-add counts as two
    operations. Operations are those the function needs, not those a
    kernel's design does: transforms as partial butterflies, Hadamards as
    butterflies, work shared between outputs counted once."""
    hw = w * h
    if name == "refs_blocks_grid":
        return (H_ * W_ + B * (780 + hw)) * 4, B * 2 * 195 * 4
    if name == "refs_blocks":
        # K1's work plus the two position arrays
        return (H_ * W_ + B * (780 + hw + 2)) * 4, B * 2 * 195 * 4
    if name == "mip_preds":
        # the plane, positions and matrix in, n_cand predictions out; per
        # block the boundary sums, per candidate the reduced prediction (a
        # multiply-add per matrix entry) and five operations per sample of
        # each upsampling stage that is not the identity
        n_modes, rb, rp = kw["geom"]
        per_cand = (rp * rp * 2 * 2 * rb + (rp * w * 5 if w > rp else 0)
                    + (hw * 5 if h > rp else 0))
        return ((H_ * W_ + 2 * B + B * M * hw) * 4 + n_modes * rp * rp * 2 * rb,
                B * (w + h + M * per_cand))
    if name == "mts_search":
        # prediction and source in, 9 B out; the five transform pairs
        # (candidate 0 is DCT2/DCT2, the others pair DST7 and DCT8)
        kw_, kh_ = kw["keep"][1]
        return (2 * B * hw * 4 + 5 * (w * w + h * h) + 16 + B * 9,
                B * mts_ops(w, h, kw_, kh_))
    if name == "predict67":
        # the references and one 64-byte descriptor per mode in, the
        # predictions out (M = 67, or a mode subset, its list read too)
        tables = M * 64 + (M * 4 if M < 67 else 0)
        return B * 780 * 4 + tables + B * M * hw * 4, B * M * hw * 12
    if name == "predict_modes":
        # the mode lists and the 67 descriptors in, of each block's
        # references the samples its modes read (ref_samples, summed over
        # the blocks: ops.tables.mode_reads of the block's list), the
        # predictions out; 12 operations per sample as K2
        R_ = kw["R"]
        return (B * R_ * 4 + 67 * 64 + kw["ref_samples"] * 4
                + B * R_ * hw * 4, B * R_ * hw * 12)
    if name == "rough_select":
        # K12c stage 1: the 35 SATDs, the mode bits and m1 in, the refine
        # list out; per block 35 costs (a conversion, a multiply-add) and
        # two scans
        return (B * 35 + 67 + 35 + B * 4) * 4, B * (35 * 3 + 33 * 2)
    if name == "rough_pick":
        # K12c stage 2: 39 SATDs, the refine list, the mode bits and m1 in,
        # the winner's prediction read and written, three values out; per
        # block 39 costs and a scan
        return ((B * (35 + 4 + 4) + 67 + 35 + 2 * B * hw + 3 * B) * 4,
                B * 39 * 4)
    if name == "fullpel_search":
        # the reference plane, the blocks, positions and penalty in; MVs
        # and cost out. corr: a multiply-add per sample and offset; r2 as
        # box sums (a square and two sliding add/subtract pairs per window
        # sample); b2; per offset three operations to combine, the penalty
        # add and a compare
        r = kw.get("r", R)
        nn = (2 * r + 1) ** 2
        return ((H_ * W_ + B * hw + 2 * B + nn + 3 * B) * 4,
                B * (nn * hw * 2 + (h + 2 * r) * (w + 2 * r) * 5 + hw * 2
                     + nn * 5))
    if name == "frac_search":
        # the reference plane, blocks, positions, MVs and penalty in; best,
        # preds [B, 49, h, w] (the winner form: [B, h, w]) and costs out.
        # Per block: the horizontal
        # 8-tap pass for the 3 fractional x phases over the h + 8 rows and
        # w + 1 columns the offsets share, the vertical 8-tap pass for the
        # 42 offsets with a fractional y, the SATD of all 49, a penalty add
        # and a compare each
        n = 8 if (w >= 8 and h >= 8) else 4
        per = (3 * (h + 8) * (w + 1) * 16 + 42 * hw * 16
               + 49 * hw * satd_ops(n) + 49 * 2)
        n_pred = 1 if kw.get("winner") else 49
        return ((H_ * W_ + B * hw + 4 * B + 49 + B * n_pred * hw + B * 49 + B)
                * 4, B * per)
    if name == "rough_refine":
        # the sum of its stages: K2 over the 35 stage-1 modes, K3, stage 1
        # (35 costs, two scans, the refine list), K12b over 4 modes, K3,
        # stage 2 (39 costs, a scan, the winner gathered), K6
        parts = [work("predict67", B, w, h, H_, W_, M=35),
                 work("satd67", B, w, h, H_, W_, M=35),
                 work("rough_select", B, w, h, H_, W_),
                 work("predict_modes", B, w, h, H_, W_, R=4,
                      ref_samples=kw["ref_samples"]),
                 work("satd67", B, w, h, H_, W_, M=4),
                 work("rough_pick", B, w, h, H_, W_),
                 work("rd_cost_pred", B, w, h, H_, W_)]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    if name in ("fwd_transform", "inv_transform"):
        # an int32 block in, an int16 block out, the two int8 matrices;
        # a 1-D DCT2 per row and per column as partial butterflies
        return (B * hw * 6 + w * w + h * h,
                B * (h * dct_ops(w) + w * dct_ops(h)))
    if name == "quant_levels":
        # an element of the caller's type in (in_bytes: 2 for K13's int16
        # coefficients, which the kernel reads in place), an int32 out;
        # |c|, a multiply-add, a shift, the sign and a clip at both ends
        return B * hw * (kw.get("in_bytes", 4) + 4), B * hw * 7
    if name == "dequant_levels":
        # a multiply-add, a shift and a clip at both ends
        return B * hw * (kw.get("in_bytes", 4) + 4), B * hw * 5
    if name == "satd67":
        n = 8 if (w >= 8 and h >= 8) else 4
        return (B * M * hw * 4 + B * hw * 4 + B * M * 4,
                B * M * hw * satd_ops(n))
    # a forward and an inverse 2-D transform of a w x h block
    tr_ops = 2 * (h * dct_ops(w) + w * dct_ops(h))
    if name == "rd_cost":
        # satds, the winning prediction and the source in; 12 B out. Per
        # block: the M costs (a conversion, a multiply, an add, a compare),
        # the residual, the two transforms, per coefficient the quantiser
        # (|c|, a multiply-add, a shift, a clip, the bucket count) and the
        # dequantiser (a multiply-add, a shift, a clip), per sample the
        # reconstruction and the SSD (an add, a clip, a subtract, a
        # multiply-add); the bits and rd, a few operations
        return (B * M * 4 + 2 * B * hw * 4 + w * w + h * h + M * 4 + 16
                + B * 12, B * (M * 4 + hw + tr_ops + hw * 7 + hw * 4
                               + hw * 6 + 10))
    if name == "rd_cost_pred":
        # prediction, source, extra bits in; rd out; K4's transforms
        return 2 * B * hw * 4 + B * 4 + w * w + h * h + 16 + B * 4, B * tr_ops
    if name == "pseudo_recon":
        # the plane in and out; per 16x16 tile a forward and an inverse
        # 2-D DCT2
        return (2 * H_ * W_ * 4 + 256,
                (H_ // 16) * (W_ // 16) * 2 * 2 * 16 * dct_ops(16))
    if name == "frame_inter":
        # src, padded ref, pen and bits tables in; per class idx, extra,
        # prediction and source blocks out. Tile SSD as b^2 - 2 corr + r^2:
        # a multiply-add per sample and offset, three operations to combine
        # per tile and offset, b^2 per tile, r^2 box sums over the padded
        # reference (a square and two sliding add/subtract pairs per
        # sample); per class: a float add per tile and offset after the
        # first, the penalty add and a compare per offset
        nn = (2 * R + 1) ** 2
        tiles = (H_ // 8) * (W_ // 8)
        cls = kw["classes"]
        out = sum(g[4] * g[5] * (8 + 2 * cw * ch * 4) for (cw, ch, g) in cls)
        ops = (tiles * nn * (64 * 2 + 3) + tiles * 64 * 2
               + (H_ + 2 * R) * (W_ + 2 * R) * 5
               + sum(g[4] * g[5] * nn * ((cw // 8) * (ch // 8) + 1)
                     for (cw, ch, g) in cls))
        return (H_ * W_ * 4 + (H_ + 2 * R) * (W_ + 2 * R) * 4 + 2 * nn * 4
                + out, ops)
    # leaf_qpel: windows, blocks, ids in; best, cost, seg out. Per tile:
    # the horizontal 8-tap pass for each of the 3 fractional x phases over
    # the 9 columns and 16 rows the 7 x offsets share; the vertical 8-tap
    # pass for the 42 offsets with a fractional y; an 8x8 SATD and a
    # segment add per offset (49). Per leaf: penalty add and compare.
    nt, nl = kw["nt"], kw["nl"]
    per_tile = (3 * 9 * 16 * 8 * 2 + 42 * 64 * 8 * 2
                + 49 * 64 * satd_ops(8) + 49)
    return (nt * (324 + 64 + 1) * 4 + 49 * 4 + nl * 51 * 4,
            nt * per_tile + nl * 49 * 2)


def ref_samples(reads, modes) -> int:
    """The reference samples K12b's function reads for mode lists modes [B,
    R] (clamped to [2, 66]), summed over the blocks: per block the union of
    its modes' rows of reads (ops.tables.mode_reads, bool [67, 780])."""
    m = np.clip(modes.cpu().numpy(), 2, 66)
    return int(reads[m].any(axis=1).sum())


def rough_stage_cases(B: int, seed: int = 0):
    """Inputs of K12c's two selection stages, for B blocks, with ties:
    [(tag, s1 [B, 35], s2 [B, 4], refine [B, 4] or None)] int32 numpy
    arrays (refine None: stage 1's list of s1). Under flat mode bits equal
    SATDs are equal costs; the callers also run the real bits. The cases:
    all 39 SATDs equal; the minimum at each slot j (stage 1 reads j =
    2..34, j = 34 the lane with two costs; stage 2 all 39, 35..38 the refine
    slots); i1 and i2 tied (two equal minima, the second later); a refine
    slot tied with a stage-1 slot, and two refine slots tied; refine lists
    at 2 and at 66; random SATDs with many repeats and wide ones."""
    rng = np.random.default_rng(seed)
    rows = np.arange(B)

    def hi(*shape):
        return rng.integers(1000, 2000, shape)

    cases = [("all equal", np.full((B, 35), 500), np.full((B, 4), 500),
              None)]
    for j in range(39):
        s1, s2 = hi(B, 35), hi(B, 4)
        if j < 35:
            s1[:, j] = 10
        else:
            s2[:, j - 35] = 10
        cases.append((f"min at {j}", s1, s2, None))
    s1 = hi(B, 35)
    p = rng.integers(2, 34, B)
    s1[rows, p] = s1[rows, rng.integers(p + 1, 35)] = 10
    cases.append(("i1 and i2 tied", s1, hi(B, 4), None))
    s1, s2 = hi(B, 35), hi(B, 4)
    s1[rows, rng.integers(0, 35, B)] = 10
    s2[rows, rng.integers(0, 4, B)] = 10
    cases.append(("refine slot tied with a stage-1 slot", s1, s2, None))
    s2 = hi(B, 4)
    r = rng.integers(0, 3, B)
    s2[rows, r] = s2[rows, rng.integers(r + 1, 4)] = 10
    cases.append(("two refine slots tied", hi(B, 35), s2, None))
    s2 = hi(B, 4)
    s2[rows, rng.integers(0, 4, B)] = 10
    ends = np.tile(np.array([2, 66, 2, 66]), (B, 1))
    ends[1::2] = (2, 3, 65, 66)
    cases.append(("refine lists at 2 and 66", hi(B, 35), s2, ends))
    cases.append(("random, repeats", rng.integers(0, 4, (B, 35)),
                  rng.integers(0, 4, (B, 4)), None))
    cases.append(("random, wide", rng.integers(0, 1 << 20, (B, 35)),
                  rng.integers(0, 1 << 20, (B, 4)), None))
    return [(t, a.astype(np.int32), b.astype(np.int32),
             None if c is None else c.astype(np.int32))
            for (t, a, b, c) in cases]


def fwd_f64(torch, x, mw, mh, s1, s2, keep_w, keep_h):
    """K13's forward as two float64 torch.matmul calls and the elementwise
    steps between them (mw, mh float64): exact where every product and sum
    stays below 2^53 and inside int32, as on the frame's residuals."""
    def step(v, s):                    # (v + 2^(s-1)) >> s, then int16 wrap
        v = torch.floor((v + 2.0 ** (s - 1)) / 2.0 ** s)
        return torch.remainder(v + 32768, 65536) - 32768
    c = step(torch.matmul(mh, step(torch.matmul(x.double(), mw.T), s1)), s2)
    c[:, keep_h:, :] = 0
    c[:, :, keep_w:] = 0
    return c.to(torch.int16)


def inv_f64(torch, c, mw, mh, s1, s2):
    """K13's inverse in the same form."""
    def step(v, s):                    # (v + 2^(s-1)) >> s, then clip16
        return torch.floor((v + 2.0 ** (s - 1)) / 2.0 ** s).clamp(-32768,
                                                                   32767)
    return step(torch.matmul(step(torch.matmul(mh.T, c.double()), s1), mw),
                s2).to(torch.int16)


def inter_classes(slice_enc, entries):
    """(w, h, grid) of the classes the dense search runs."""
    return tuple((w, h, g)
                 for (_k, w, h, _p, g) in slice_enc._inter_entries(entries))


SLICE = {0: "B", 1: "P", 2: "I"}      # consts.SliceType


def encode(enc, planes, clip):
    out = []
    for f in clip:
        out.extend(enc.feed(planes(*f) if isinstance(f, tuple) else f))
    out.extend(enc.flush())
    return out


def kernel_name(name: str) -> str:
    """A profiler event's name without its namespace and arguments."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:60]


def busy_share(torch, run, every=False):
    """Device busy time by kernel over one run under torch.profiler: the
    eight largest, or every kernel with its launch count (every=True)."""
    prof_act = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=prof_act) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy, calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernel_name(e.name)
            busy[k] = busy.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
            calls[k] = calls.get(k, 0) + 1
    busy_ms = sum(busy.values())
    if busy_ms <= 0:
        return ("  device busy: not measured (the profiler saw no device "
                "events)")
    top = sorted(busy.items(), key=lambda kv: -kv[1])
    if not every:
        top = top[:8]
    return (f"  device busy {busy_ms:.3f} ms of {pwall * 1e3:.3f} ms "
            f"profiled wall ({busy_ms / (pwall * 1e3):.4f} busy share); "
            + "; ".join(f"{k} {v:.3f} ms" + (f" x{calls[k]}" if every else "")
                        for k, v in top))


def mesh_cards(torch, kernels):
    """Phase 14: the meshes with one launch set a shard, on four streams of
    card 0 and then over the first 4 (or 2) cards where the machine has
    them, every frame held to the plain Encoder's on card 0 (and to
    phase 12's fixture where a run encodes phase 12's frames); then the
    batched (gop 4, tile 1) mesh on a 3840x2160 batch of 4. Returns
    ({path: launches}, comparisons); fails on any difference."""
    from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes
    from uvg266_tpu_torch.ops import intra_batch as ib
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.parallel import (MeshEncoder, MeshGopEncoder,
                                           build_gop_mesh, build_mesh)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CTC_FIXTURE)) as fh:
        fixture = json.load(fh)["encodes"]
    t14 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    print(f"phase 14 cards: torch.cuda.device_count() = {n_cards}", flush=True)
    card0 = torch.device("cuda", 0)
    n_spread = 4 if n_cards >= 4 else 2
    layouts = [("4 streams of card 0", ["cuda:0"] * 4)]
    if n_cards >= 2:
        layouts.append((f"{n_spread} cards",
                        [f"cuda:{i % n_spread}" for i in range(4)]))
    else:
        print("phase 14: this machine has one card: the spread over several "
              "cards is not run here", flush=True)
    counts, n_checks = {}, [0]

    def expect(path, launches, want):
        for name in REPLACES:
            if launches.get(name, 0) != want.get(name, 0):
                fail(f"{path} launched {name} {launches.get(name, 0)} "
                     f"times, expected {want.get(name, 0)}")
        counts[path] = launches

    def same(what, a, b):
        n_checks[0] += 1
        if a != b:
            fail(f"{what}: differs")

    def same_frames(what, got, want):
        if len(got) != len(want):
            fail(f"{what}: {len(got)} frames against {len(want)}")
        for i, ((au_m, rec_m), (au_p, rec_p)) in enumerate(zip(got, want)):
            same(f"{what} frame {i} AU", au_m, au_p)
            for pl in ("y", "u", "v"):
                same(f"{what} frame {i} recon {pl}",
                     np.asarray(getattr(rec_m, pl)).tobytes(),
                     np.asarray(getattr(rec_p, pl)).tobytes())

    def same_as_fixture(what, label, outs, cfg):
        want = fixture[label]["port"]
        got = frame_digests(outs, cfg)
        if len(got) > len(want):
            fail(f"{what}: {len(got)} frames, the fixture holds {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            for key in ("type", "au", "au_bytes", "recon", "rec_out"):
                same(f"{what} frame {i} {key} against the fixture", a[key],
                     b[key])

    def sync_all():
        for i in range(n_cards):
            torch.cuda.synchronize(i)

    def per_card():
        return {d: {k: v for k, v in c.items() if v}
                for d, c in sorted(kernels.LAUNCHES_BY_DEVICE.items())}

    def profiled_by_card(run):
        """(run's result, profiled wall s, {card: device busy ms}, {card:
        peak max_memory_allocated B}) of one run under torch.profiler."""
        for i in range(n_cards):
            torch.cuda.reset_peak_memory_stats(i)
        prof_act = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=prof_act) as prof:
            t0 = time.perf_counter()
            out = run()
            sync_all()
            pwall = time.perf_counter() - t0
        busy = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy[e.device_index] = busy.get(e.device_index, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        peak = {i: torch.cuda.max_memory_allocated(i) for i in range(n_cards)
                if torch.cuda.max_memory_allocated(i)}
        return out, pwall, busy, peak

    def card_line(busy, peak, pwall):
        return "; ".join(
            f"cuda:{i} busy {busy.get(i, 0.0):.3f} ms "
            f"({busy.get(i, 0.0) / (pwall * 1e3):.4f} busy share), peak "
            f"{peak.get(i, 0)} B" for i in sorted(set(busy) | set(peak)))

    def plain_card0(pcfg, pclip):
        """The plain Encoder's frames on card 0, their launches, and its
        wall s."""
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = encode(Encoder(pcfg, device=card0), FramePlanes, pclip)
        torch.cuda.synchronize(card0)
        return ([o[:2] for o in outs], dict(kernels.LAUNCHES),
                time.perf_counter() - t0, outs)

    # 14a: MeshEncoder, (gop 1, tile 4): phase 12's all-intra QP22 with 2x2
    # tiles and wpp off, one launch set a tile
    acfg = dataclasses.replace(ctc_config("1080p allintra q22"),
                               tiles_width_count=2, tiles_height_count=2,
                               wpp=False)
    aclip = [FramePlanes(*f) for f in ctc_clip(1920, 1080, MESH14_AI)]
    a_ref, _l, a_wall, _o = plain_card0(acfg, aclip)
    for lab, devs in layouts:
        menc = MeshEncoder(acfg, build_mesh(4, n_gop=1, devices=devs))
        kernels.reset_launches()
        got, pwall, busy, peak = profiled_by_card(lambda: menc.encode(aclip))
        by = per_card()
        want = dict.fromkeys(INTRA_KERNELS[1:], 0)
        for classes, _d in menc._tile_plan()[0]:
            for c in classes:
                k1 = "refs_blocks_grid" if c[2] is not None else "refs_blocks"
                want[k1] = want.get(k1, 0) + len(aclip)
                for k in INTRA_KERNELS[1:]:
                    want[k] += len(aclip)
        expect(f"sharded all-intra, {lab}", dict(kernels.LAUNCHES), want)
        if sorted(by) != sorted(set(devs)):
            fail(f"14a {lab}: launches on {sorted(by)}, mesh on {devs}")
        same_frames(f"14a {lab}", got, a_ref)
        print(f"phase 14a MeshEncoder (gop 1, tile 4) on {lab}: "
              f"{len(aclip)} frames 1920x1080 QP22 all-intra, 2x2 tiles, in "
              f"{pwall:.3f} s = {len(aclip) / pwall:.3f} fps wall (profiled;"
              f" the plain Encoder {len(aclip) / a_wall:.3f} fps), "
              f"{sum(len(a) for a, _r in got)} bytes equal the plain "
              f"Encoder's on cuda:0, frame RD "
              + ", ".join(f"{v:.1f}" for v in menc.frame_rd_stats)
              + f"; {card_line(busy, peak, pwall)}; launches by card "
              + json.dumps(by), flush=True)

    # 14b: MeshGopEncoder, closed-GOP runs of 2 frames, one launch set a
    # run on its card, each run held to a plain Encoder's on card 0: phase
    # 12's LD QP22 (wpp off) over four runs of distinct frames; the Config
    # default (rdoq on: K8 on each run's card; two runs, its Python
    # finalize takes 5-7 s a 1080p frame) and the 10-bit LD (K9a, K9b, K6
    # on each run's card; four runs), each run on phase 12's two frames,
    # held to the fixture as well
    for label, gcfg, G, fixture_label in (
            ("LD QP22", dataclasses.replace(
                ctc_config("1080p lowdelay q22"), wpp=False), 4, None),
            ("default QP27", ctc_config("1080p default q27"), 2,
             "1080p default q27"),
            ("10-bit LD QP27", ctc_config("1080p ld10 q27"), 4,
             "1080p ld10 q27")):
        L = MESH14_LD
        bd = gcfg.input_bitdepth
        if fixture_label is None:
            clip = ctc_clip(1920, 1080, G * L, bd)
            runs = [clip[g * L:(g + 1) * L] for g in range(G)]
            refs = [plain_card0(gcfg, [FramePlanes(*f) for f in r])
                    for r in runs]
        else:
            base = ctc_clip(1920, 1080, L, bd)
            runs = [[tuple(pl.copy() for pl in f) for f in base]
                    for _g in range(G)]
            refs = [plain_card0(gcfg, [FramePlanes(*f) for f in base])] * G
            same_as_fixture(f"14b {label} plain", fixture_label,
                            [(o[0], o[1], int(o[2].slicetype))
                             for o in refs[0][3]], gcfg)
        want = {k: sum(r[1].get(k, 0) for r in refs) for k in REPLACES}
        p_wall = sum(r[2] for r in refs)
        gclip = [FramePlanes(*f) for r in runs for f in r]
        for lab, devs in layouts:
            genc = MeshGopEncoder(gcfg, build_gop_mesh(G, devices=devs[:G]))
            kernels.reset_launches()
            gres, pwall, busy, peak = profiled_by_card(
                lambda: genc.encode(gclip))
            by = per_card()
            if genc.disp.n_fallback or not genc.disp.n_batched:
                fail(f"14b {label} {lab}: {genc.disp.n_batched} batched "
                     f"steps, {genc.disp.n_fallback} fallbacks")
            # a launch set a run: the runs' launches are their own encodes'
            expect(f"sharded gop {label}, {lab}", dict(kernels.LAUNCHES), want)
            if sorted(by) != sorted(set(devs[:G])):
                fail(f"14b {label} {lab}: launches on {sorted(by)}")
            for g in range(G):
                same_frames(f"14b {label} {lab} run {g}",
                            [o[:2] for o in gres[g]], refs[g][0])
            types = "".join(SLICE[o[2].slicetype] for o in gres[0])
            print(f"phase 14b MeshGopEncoder {label} on {lab}: {G} runs of "
                  f"{L} frames 1920x1080 ({types}) in {pwall:.3f} s = "
                  f"{G * L / pwall:.3f} fps wall (profiled; the plain "
                  f"Encoders one after the other {G * L / p_wall:.3f} fps), "
                  f"{genc.disp.n_batched} batched steps, 0 fallbacks, "
                  f"{sum(len(o[0]) for r in gres for o in r)} bytes equal "
                  "the plain Encoders' on cuda:0"
                  + ("" if fixture_label is None else " and the fixture's")
                  + f"; {card_line(busy, peak, pwall)}; launches by card "
                  + json.dumps(by), flush=True)
            del gres, genc

    # 14c: the (gop 4, tile 1) mesh batched on card 0 at 3840x2160 10 bits:
    # one search of 4 frames, K2's output past 2^31 elements; each
    # wrapper's largest element offset recorded on the way
    ucfg = ctc_config("2160p ai10 q22")
    uclip = [FramePlanes(*f) for f in ctc_clip(3840, 2160, 4, 10)]
    u_ref, _l, u_wall, _o = plain_card0(ucfg, uclip)
    uenc = MeshEncoder(ucfg, build_mesh(4, n_gop=4, device=card0))
    largest = {}
    wrapped = {"refs_blocks_grid": ib, "predict67": ib, "satd67": ib,
               "rd_cost": rc}
    plain_fn = {k: getattr(m, k) for k, m in wrapped.items()}

    def recording(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            ts = [t for t in (*a, *k.values(),
                              *(out if isinstance(out, tuple) else (out,)))
                  if isinstance(t, torch.Tensor)]
            largest[name] = max(largest.get(name, 0),
                                max(t.numel() for t in ts) - 1)
            return out
        return call
    for name, mod in wrapped.items():
        setattr(mod, name, recording(name, plain_fn[name]))
    kernels.reset_launches()
    try:
        ugot, pwall, busy, peak = profiled_by_card(lambda: uenc.encode(uclip))
    finally:
        for name, mod in wrapped.items():
            setattr(mod, name, plain_fn[name])
    if largest.get("predict67", 0) < 2 ** 31:
        fail("14c: the batch's K2 output does not pass 2^31 elements")
    n_cls = sum(1 for cl in uenc._search_classes()[1] if cl["positions"])
    expect("batched 2160p gop 4", dict(kernels.LAUNCHES),
           dict.fromkeys(INTRA_KERNELS, n_cls))
    same_frames("14c 2160p", ugot, u_ref)
    print(f"phase 14c MeshEncoder (gop 4, tile 1) batched on cuda:0: 4 frames"
          f" 3840x2160 10-bit QP22 in one search ({n_cls} classes, one "
          f"launch of K1-K4 a class) in {pwall:.3f} s = {4 / pwall:.3f} fps "
          f"wall (profiled; the plain Encoder {4 / u_wall:.3f} fps), "
          f"{sum(len(a) for a, _r in ugot)} bytes equal the plain Encoder's;"
          f" {card_line(busy, peak, pwall)}; largest element offset each "
          "wrapper's tensors reach, against 2^31 = 2147483648: "
          + ", ".join(f"{k} {v} ({v / 2 ** 31:.3f})"
                      for k, v in largest.items()), flush=True)
    del ugot, u_ref, uenc
    torch.cuda.empty_cache()
    print(f"phase 14 meshes over several cards: {n_checks[0]} comparisons, "
          f"all equal, {len(layouts)} layout(s), {n_cards} card(s); took "
          f"{time.perf_counter() - t14:.3f} s", flush=True)
    return counts, n_checks[0]


def mesh_cards_main() -> int:
    """``python3 chip_smoke.py --mesh-cards``: the card line, the build,
    then phase 14 alone (on a machine with several cards, the spread over
    them and what it is compared with, and no other phase)."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    import uvg266_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from uvg266_tpu_torch import kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    kernels.build([n for n in kernels.SIGNATURES
                   if kernels.source_of(n) not in LATE_SOURCES])
    print(f"phase 2 build: {time.perf_counter() - t0:.3f} s wall", flush=True)
    got, n = mesh_cards(torch, kernels)
    print(json.dumps({"mesh_cards": {"comparisons": n, "launches": got}}),
          flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    import uvg266_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from uvg266_tpu_torch import kernels
    from uvg266_tpu_torch.cfg import PRESETS, Config, make_config
    from uvg266_tpu_torch.consts import SliceType
    from uvg266_tpu_torch.control.encoder import (Encoder, FramePlanes,
                                                  RefLists, SliceEncoder)
    from uvg266_tpu_torch.control.params import EncoderControl
    from uvg266_tpu_torch.control.partition import (PartitionSearch,
                                                    qp_to_lambda)
    from uvg266_tpu_torch.ops import intra_batch as ib
    from uvg266_tpu_torch.ops import me
    from uvg266_tpu_torch.ops import me_frame as mf
    from uvg266_tpu_torch.ops import mip as mp
    from uvg266_tpu_torch.ops import pseudo_recon as pr
    from uvg266_tpu_torch.ops import quant as qu
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.ops import transforms as tr
    from uvg266_tpu_torch.ops.tr_matrices import (DCT2, DCT8, DST7,
                                                  device_matrix)
    from uvg266_tpu_torch.ops.tables import (device_mts_tables, device_tables,
                                             frame_tables, me_penalties,
                                             mip_matrix, mip_mode_bits,
                                             mode_reads, rough_modes)
    from uvg266_tpu_torch.oracle.decoder import decode_au

    dev = torch.device("cuda")
    card_kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    stamps = [("1", t_start)]

    def stamp(phase):
        stamps.append((phase, time.perf_counter()))

    # --- 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"phase 1 card: {card_kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, count {torch.cuda.device_count()}",
          flush=True)

    # the CPU half of phases 8, 11 and 12 in child processes, one task an
    # encode, in the order the phases need them
    pool = multiprocessing.get_context("spawn").Pool(CHILD_PROCS)
    _CHILDREN.append(pool)
    t_child = time.perf_counter()
    cpu8, cpu11, ctc_half = (
        [pool.apply_async(fn, ([job],)) for job in jobs]
        for fn, jobs in ((cpu_encodes, phase8_jobs()),
                         (cpu_encodes, phase11_jobs(PRESETS)),
                         (ctc_cpu_encodes, CTC_CPU)))

    def cpu_half(tasks, phase):
        """The child tasks' merged results -> ({label: frames}, the seconds
        they took together), within 600 s of this call."""
        t0 = time.perf_counter()
        out, secs = {}, 0.0
        for task in tasks:
            try:
                got, s_ = task.get(timeout=max(1.0, 600 - (
                    time.perf_counter() - t0)))
            except multiprocessing.TimeoutError:
                fail(f"phase {phase}: the CPU half did not finish within "
                     "600 s")
            except Exception as e:      # raised in a child, re-raised here
                fail(f"phase {phase}: the CPU half failed: {e!r}")
            out.update(got)
            secs += s_
        print(f"phase {phase} CPU half: {len(out)} encodes in "
              f"{CHILD_PROCS} child processes ({CHILD_THREADS} threads "
              f"each), {secs:.3f} s of their time, started "
              f"{t0 - t_child:.3f} s before phase {phase} asked for them "
              f"({t0 - t_start:.3f} s after phase 1), waited "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        return out

    # --- 2. build -----------------------------------------------------------
    stamp("2")
    t_build = time.perf_counter()
    late = subprocess.Popen([sys.executable, "-c", LATE_BUILD],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    _CHILDREN.append(late)
    secs = kernels.build([n for n in kernels.SIGNATURES
                          if kernels.source_of(n) not in LATE_SOURCES])
    print(f"phase 2 build: {time.perf_counter() - t_build:.3f} s wall, "
          "per kernel "
          + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
          + f"; {', '.join(LATE_SOURCES)} in a process of their own until "
          "phase 4d", flush=True)

    def ptxas(names):
        for name in names:
            usage = [ln.strip() for ln in kernels.build_log(name).splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"  ptxas {name}: {' | '.join(usage)}", flush=True)
    ptxas(secs)

    # --- 3. each all-intra kernel against its plain version -----------------
    stamp("3")
    cfg = bench_config(Config)
    ctrl = EncoderControl(cfg)
    frames = synth_clip()
    probe = SliceEncoder(cfg, ctrl, device=dev)
    entries = probe._fused_entries(PartitionSearch(ctrl, cfg, qp=QP))
    classes = [(w, h, g) for (_k, w, h, _p, g) in entries]
    print("phase 3 classes: " + ", ".join(
        f"{w}x{h} B={g[4] * g[5]}" for (w, h, g) in classes), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1234)
    err = dict.fromkeys(REPLACES, 0.0)
    ms = dict.fromkeys(REPLACES, 0.0)
    # device time from graph replay, for the all-intra kernels (their
    # wrappers only allocate and launch); the others stay None
    dev_ms = dict.fromkeys(REPLACES)
    plain_ms = dict.fromkeys(REPLACES, 0.0)
    library_ms = dict.fromkeys(REPLACES)
    bytes_ = dict.fromkeys(REPLACES, 0)
    ops = dict.fromkeys(REPLACES, 0)
    checks = 0

    def same(name, what, a, b):
        nonlocal checks
        checks += 1
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name} {what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        d = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        err[name] = max(err[name], d)
        if d != 0.0:
            fail(f"{name} {what}: kernel and plain version differ by {d}")

    def timed(name, kern, plain, label, n_kern=20, n_plain=3, account=True,
              graph=None, **kw):
        # account=False: printed only (K3/K4 at a MIP candidate count; their
        # rows in the JSON line stay the 67-mode times of the all-intra path);
        # graph: what the CUDA graph replays in place of kern
        # -> (kernel ms, graph ms or None, bound ms)
        k_ms = time_ms(torch, kern, n_kern)
        p_ms = time_ms(torch, plain, n_plain)
        g_ms = (graph_ms(torch, graph or kern, n_kern)
                if name in GRAPH_KERNELS else None)
        b, o = work(name, **kw)
        if account:
            if g_ms is not None:
                dev_ms[name] = (dev_ms[name] or 0.0) + g_ms
            ms[name] += k_ms
            plain_ms[name] += p_ms
            bytes_[name] += b
            ops[name] += o
        bound = max(b / HBM_BYTES_PER_S, o / OPS_PER_S) * 1e3
        before = (EARLIER_MS.get((name, kw["w"])) if kw["w"] == kw["h"]
                  else None)
        print(f"  {name} {label}: {k_ms:.4f} ms kernel"
              + ("" if g_ms is None else f" ({g_ms:.4f} ms device, graph)")
              + f", {p_ms:.4f} ms plain, bound {bound:.4f} ms ({b} B, {o} ops)"
              + ("" if before is None or not account
                 else f"; earlier design {before:.4f} ms"),
              flush=True)
        return k_ms, g_ms, bound

    frame_src = torch.from_numpy(frames[0][0]).to(dev)
    pseudo0 = pr.pseudo_recon(frame_src, LD_QP, 8)

    def checker(bd):
        """An 8x8 checkerboard of 0 and the maximum sample."""
        return (((torch.arange(H, device=dev)[:, None] // 8
                  + torch.arange(W, device=dev)[None] // 8) % 2)
                * ((1 << bd) - 1)).to(torch.int32)

    def class_planes(bd):
        """The planes the per-class kernels are checked on: random, 8x8
        checkerboard of 0 and the maximum, and at 8 bits the clip's frame."""
        mx = (1 << bd) - 1
        planes = {"rand": torch.randint(0, mx + 1, (H, W), generator=gen,
                                        device=dev, dtype=torch.int32),
                  "edge": checker(bd)}
        if bd == 8:
            planes["frame"] = frame_src
        return planes

    for (w, h, g) in classes:
        B = g[4] * g[5]
        for bd in (8, 10):
            mx = (1 << bd) - 1
            tabs = device_tables(w, h, bd, "cuda")
            for tag, src in class_planes(bd).items():
                what = f"{w}x{h} {bd}-bit {tag}"
                refs, blocks = ib.refs_blocks_grid(src, w, h, g)
                pr_, pb = ib.refs_blocks_grid_plain(src, w, h, g)
                same("refs_blocks_grid", what + " refs", refs, pr_)
                same("refs_blocks_grid", what + " blocks", blocks, pb)
                if tag == "frame":                 # the inter-slice screen
                    rr, rb = ib.refs_blocks_grid(src, w, h, g, pseudo0)
                    qr, qb = ib.refs_blocks_grid_plain(src, w, h, g, pseudo0)
                    same("refs_blocks_grid", what + " refsrc refs", rr, qr)
                    same("refs_blocks_grid", what + " refsrc blocks", rb, qb)
                ref_sets = {tag: refs}
                if tag == "rand":
                    ref_sets["rand refs"] = torch.randint(
                        0, mx + 1, refs.shape, generator=gen, device=dev,
                        dtype=torch.int32)
                for rtag, rr in ref_sets.items():
                    preds = ib.predict67(rr, tabs)
                    same("predict67", f"{w}x{h} {bd}-bit {rtag}", preds,
                         ib.predict67_plain(rr, tabs))
                    pairs = [(preds, blocks)]
                    if tag == "edge":
                        # largest residuals: int32 wrap of the 10-bit SSD
                        pairs.append((torch.zeros_like(preds),
                                      torch.full_like(blocks, mx)))
                    for k, (pp, bb) in enumerate(pairs):
                        wt = f"{w}x{h} {bd}-bit {rtag} #{k}"
                        satds = ib.satd67(pp, bb)
                        same("satd67", wt, satds, ib.satd67_plain(pp, bb))
                        for qp in (22, 37):
                            qps = qp + 6 * (bd - 8)
                            lam = float(np.float32(qp_to_lambda(qp)))
                            ft = frame_tables(qp, "cuda")
                            args = (pp, bb, satds, qps, lam, ft["wts"],
                                    ft["mode_bits"], tabs, bd)
                            got = rc.rd_cost(*args)
                            want = rc.rd_cost_plain(*args)
                            for o, (a, b) in zip(("best", "rd", "satd"),
                                                 zip(got, want)):
                                same("rd_cost", f"{wt} qp{qp} {o}", a, b)
        # times at the frame's inputs (8 bits, QP22), once per class
        tabs = device_tables(w, h, 8, "cuda")
        ft = frame_tables(QP, "cuda")
        lam = float(np.float32(qp_to_lambda(QP)))
        refs, blocks = ib.refs_blocks_grid(frame_src, w, h, g)
        preds = ib.predict67(refs, tabs)
        satds = ib.satd67(preds, blocks)
        rd_args = (preds, blocks, satds, QP, lam, ft["wts"], ft["mode_bits"],
                   tabs, 8)
        shape = dict(B=B, w=w, h=h, H_=H, W_=W)
        timed("refs_blocks_grid",
              lambda: ib.refs_blocks_grid(frame_src, w, h, g),
              lambda: ib.refs_blocks_grid_plain(frame_src, w, h, g),
              f"{w}x{h}", **shape)
        timed("predict67", lambda: ib.predict67(refs, tabs),
              lambda: ib.predict67_plain(refs, tabs), f"{w}x{h}", **shape)
        timed("satd67", lambda: ib.satd67(preds, blocks),
              lambda: ib.satd67_plain(preds, blocks), f"{w}x{h}", **shape)
        timed("rd_cost", lambda: rc.rd_cost(*rd_args),
              lambda: rc.rd_cost_plain(*rd_args), f"{w}x{h}", **shape)
        del refs, blocks, preds, satds, rd_args
    # K2 and K4 at the BT/TT shapes: the class grid, one block and 37
    # blocks (not a multiple of K4's blocks per thread block), all 67 modes
    # and the rough search's 35, K4 over 67, 35, 16 and 12 candidates
    m35 = rough_modes("cuda")
    for (w, h) in LATTICE_SHAPES:
        g = (0, 0, w, h, W // w, H // h)
        for bd in (8, 10):
            mx = (1 << bd) - 1
            tabs = device_tables(w, h, bd, "cuda")
            for tag, src in class_planes(bd).items():
                what = f"{w}x{h} {bd}-bit {tag}"
                refs, blocks = ib.refs_blocks_grid(src, w, h, g)
                pr_, pb = ib.refs_blocks_grid_plain(src, w, h, g)
                same("refs_blocks_grid", what + " refs", refs, pr_)
                same("refs_blocks_grid", what + " blocks", blocks, pb)
                for mtag, ml in (("M=67", None), ("M=35", m35)):
                    preds = ib.predict67(refs, tabs, ml)
                    same("predict67", f"{what} {mtag}", preds,
                         ib.predict67_plain(refs, tabs, ml))
                preds = ib.predict67(refs, tabs)
                pairs = [("", preds, blocks)]
                if tag == "edge":
                    pairs.append((" max", torch.zeros_like(preds),
                                  torch.full_like(blocks, mx)))
                ft = frame_tables(22, "cuda")
                lam = float(np.float32(qp_to_lambda(22)))
                for ptag, pp, bb in pairs:
                    for M_ in (67, 35, 16, 12):
                        mb = (ft["mode_bits"][:M_].contiguous() if M_ >= 35
                              else mip_mode_bits(M_, "cuda"))
                        for nb in (pp.shape[0], 1, 37):
                            p_ = pp[:nb, :M_].contiguous()
                            b_ = bb[:nb].contiguous()
                            satds = ib.satd67(p_, b_)
                            args = (p_, b_, satds, 22 + 6 * (bd - 8), lam,
                                    ft["wts"], mb, tabs, bd)
                            for o, (a, b) in zip(
                                    ("best", "rd", "satd"),
                                    zip(rc.rd_cost(*args),
                                        rc.rd_cost_plain(*args))):
                                same("rd_cost", f"{what}{ptag} M={M_} "
                                     f"B={nb} {o}", a, b)
                del refs, blocks, preds, pairs
    # K1 and K12a where the 3w+3 top line and the 3h+3 left line leave the
    # plane: a K1 grid whose blocks leave it at the right and bottom edges
    # (clamped), off the 4-sample grid, two frames with a separate
    # reference plane; K12a at the corners, next to the right edge and off
    # the 4-sample grid; every class and BT/TT shape, 8 and 10 bits
    pseudo2 = torch.stack([pseudo0, frame_src])
    for (w, h) in [(c[0], c[1]) for c in classes] + list(LATTICE_SHAPES):
        xs = np.array([0, W - w, 0, W - w, W - w - 1,
                       max(0, W - 3 * w - 1), 5], dtype=np.int32)
        ys = np.array([0, 0, H - h, H - h, 3, H - h - 1, H - 2 * h],
                      dtype=np.int32)
        grids = ((W - 2 * w - 1, H - h - 2, w, h, 3, 2),
                 (max(2, W - 3 * w + 2), 1, 2 * w, h, 2, 3))
        for bd in (8, 10):
            for tag, src in class_planes(bd).items():
                what = f"{w}x{h} {bd}-bit {tag} edge"
                for o, a, b in zip(("refs", "blocks"),
                                   ib.refs_blocks(src, xs, ys, w, h),
                                   ib.refs_blocks_plain(src, xs, ys, w, h)):
                    same("refs_blocks", f"{what} {o}", a, b)
                src2 = torch.stack([src, src.flip(1).contiguous()])
                for g in grids:
                    for o, a, b in zip(
                            ("refs", "blocks"),
                            ib.refs_blocks_grid(src2, w, h, g, pseudo2),
                            ib.refs_blocks_grid_plain(src2, w, h, g,
                                                      pseudo2)):
                        same("refs_blocks_grid", f"{what} {g} F=2 {o}", a, b)
    del pseudo2, src2
    print(f"phase 3 intra kernels: {checks} comparisons, all equal",
          flush=True)

    # --- 4. each inter kernel against its plain version ---------------------
    stamp("4")
    n0 = checks
    # K5: the plane the P/B intra screen reads its references from
    for bd in (8, 10):
        mx = (1 << bd) - 1
        planes = {"rand": torch.randint(0, mx + 1, (H, W), generator=gen,
                                        device=dev, dtype=torch.int32),
                  "edge": (((torch.arange(H, device=dev)[:, None]
                             + torch.arange(W, device=dev)[None]) % 2)
                           * mx).to(torch.int32)}
        if bd == 8:
            planes["frame"] = frame_src
        for tag, src in planes.items():
            for qp in (22, 27, 37):
                qps = qp + 6 * (bd - 8)
                same("pseudo_recon", f"{bd}-bit {tag} qp{qp}",
                     pr.pseudo_recon(src, qps, bd),
                     pr.pseudo_recon_plain(src, qps, bd))
    # K5 where its tile count is not a multiple of its tiles per thread
    # block (144x80, the 136x72 LD clip's padded plane: 45 tiles) and on a
    # 1920x1088 plane: random, checkerboard, all-max and (8 bits) the clip,
    # qp_scaled 0, 22, 37 and the largest
    big = torch.from_numpy(synth_clip(1920, 1088, 1)[0][0]).to(dev)
    for (ph, pw) in ((80, 144), (1088, 1920)):
        for bd in (8, 10):
            mx = (1 << bd) - 1
            planes = {
                "rand": torch.randint(0, mx + 1, (ph, pw), generator=gen,
                                      device=dev, dtype=torch.int32),
                "edge": (((torch.arange(ph, device=dev)[:, None]
                           + torch.arange(pw, device=dev)[None]) % 2)
                         * mx).to(torch.int32),
                "max": torch.full((ph, pw), mx, dtype=torch.int32,
                                  device=dev)}
            if bd == 8:
                planes["clip"] = big[:ph, :pw].contiguous()
            for tag, src in planes.items():
                for qps in (0, 22, 37, 51 + 6 * (bd - 8)):
                    same("pseudo_recon", f"{pw}x{ph} {bd}-bit {tag} qp{qps}",
                         pr.pseudo_recon(src, qps, bd),
                         pr.pseudo_recon_plain(src, qps, bd))
    timed("pseudo_recon", lambda: pr.pseudo_recon(frame_src, LD_QP, 8),
          lambda: pr.pseudo_recon_plain(frame_src, LD_QP, 8), f"{W}x{H}",
          B=0, w=16, h=16, H_=H, W_=W)
    timed("pseudo_recon", lambda: pr.pseudo_recon(big, LD_QP, 8),
          lambda: pr.pseudo_recon_plain(big, LD_QP, 8), "1920x1088",
          account=False, B=0, w=16, h=16, H_=1088, W_=1920)
    print(f"  pseudo_recon 1920x1088: earlier design "
          f"{K5_BEFORE_MS['1920x1088']:.4f} ms device (graph)", flush=True)
    del big
    # K7 + K6: frame 1 against frame 0, the dense path's inter classes
    dcfg = dense_config(Config)
    dctrl = EncoderControl(dcfg)
    dprobe = SliceEncoder(dcfg, dctrl, device=dev)
    # the size classes are fixed by the encoder's first (intra) frame and
    # kept for its inter frames
    dentries = dprobe._fused_entries(PartitionSearch(dctrl, dcfg, qp=LD_QP))
    iclasses = inter_classes(dprobe, dentries)
    print("phase 4 inter classes: " + ", ".join(
        f"{w}x{h} B={g[4] * g[5]}" for (w, h, g) in iclasses), flush=True)
    cur, ref_pad, pen, bits_tab = k7_inputs(torch, frames, dev)
    lam_i = float(np.float32(qp_to_lambda(LD_QP, False)))
    found = mf.frame_inter(cur, ref_pad, pen, bits_tab, iclasses, R)
    want = mf.frame_inter_plain(cur, ref_pad, pen, bits_tab, iclasses, R)
    for (w, h, _g), got_c, want_c in zip(iclasses, found, want):
        for o, a, b in zip(("idx", "pred", "blk", "extra"), got_c, want_c):
            same("frame_inter", f"{w}x{h} {o}", a, b)
    # the tile pass alone (the C entry with no class) against the plain
    # tile SSD maps, and the reference's own formulation (a chain of
    # convolutions: the row's library time) against the kernel's map
    nn = 2 * R + 1
    ssd = torch.empty(((H // 8) * (W // 8), nn * nn), dtype=torch.int32,
                      device=dev)
    k7_tile_pass(kernels, cur, ref_pad, R, pen, bits_tab, ssd)
    same("frame_inter", "tile SSD maps", ssd,
         mf._tile_ssd_plain(cur, ref_pad, R))
    chain = k7_library(torch, cur, ref_pad, R)
    lib_d = (chain().double().reshape(ssd.shape) - ssd.double()).abs().max()
    library_ms["frame_inter"] = time_ms(torch, chain, 20)
    _k, k7_dev, _b = timed(
        "frame_inter",
        lambda: mf.frame_inter(cur, ref_pad, pen, bits_tab, iclasses, R),
        lambda: mf.frame_inter_plain(cur, ref_pad, pen, bits_tab, iclasses,
                                     R), f"{W}x{H} 1 ref",
        B=0, w=8, h=8, H_=H, W_=W, classes=iclasses)
    tile_dev = graph_ms(torch, lambda: k7_tile_pass(
        kernels, cur, ref_pad, R, pen, bits_tab, ssd), 20)
    print(f"  frame_inter by pass (device, graph): tile {tile_dev:.4f} ms, "
          f"class {k7_dev - tile_dev:.4f} ms (earlier design: whole "
          f"{K78_BEFORE_MS[('frame_inter', 'whole')]:.4f}, tile "
          f"{K78_BEFORE_MS[('frame_inter', 'tile')]:.4f}); library chain "
          f"{library_ms['frame_inter']:.4f} ms (events), largest |chain - "
          f"tile map| {lib_d.item():.1f}", flush=True)
    del ssd, chain
    ft = frame_tables(LD_QP, "cuda")
    for (w, h, g), (_idx, pred, blk, extra) in zip(iclasses, found):
        tabs = device_tables(w, h, 8, "cuda")
        for qp in (22, 27, 37):
            a = (pred, blk, qp, float(np.float32(qp_to_lambda(qp, False))),
                 frame_tables(qp, "cuda")["wts"], extra, tabs, 8)
            same("rd_cost_pred", f"{w}x{h} qp{qp}", rc.rd_cost_pred(*a),
                 rc.rd_cost_pred_plain(*a))
        a = (pred, blk, LD_QP, lam_i, ft["wts"], extra, tabs, 8)
        timed("rd_cost_pred", lambda: rc.rd_cost_pred(*a),
              lambda: rc.rd_cost_pred_plain(*a), f"{w}x{h}",
              B=g[4] * g[5], w=w, h=h, H_=H, W_=W)
    # K6 at every (w, h) in {4..64}^2: frame 0's w x h blocks against
    # frame 1's co-located blocks as the prediction, and the all-max
    # residual (zero prediction); 8 and 10 bits, quant rounding 85 and 171
    # (the rough intra search's); every block, one and 37 blocks
    def cut(plane, w, h):
        """The w x h blocks of a plane, cropped to whole blocks."""
        p_ = torch.from_numpy(plane[:H // h * h, :W // w * w]).to(dev)
        return p_.reshape(H // h, h, W // w, w).transpose(1, 2) \
            .reshape(-1, h, w).contiguous()
    for w in (4, 8, 16, 32, 64):
        for h in (4, 8, 16, 32, 64):
            blk8, prd8 = cut(frames[0][0], w, h), cut(frames[1][0], w, h)
            B = blk8.shape[0]
            extra = torch.rand(B, generator=gen, device=dev) * 9
            for bd in (8, 10):
                mx, sc = (1 << bd) - 1, 1 << (bd - 8)
                tabs = device_tables(w, h, bd, "cuda")
                pairs = {"frame": (prd8 * sc, blk8 * sc),
                         "max": (torch.zeros_like(blk8),
                                 torch.full_like(blk8, mx))}
                for tag, (pp, bb) in pairs.items():
                    for intra in (False, True):
                        for nb in (B, 1, 37):
                            a = (pp[:nb], bb[:nb], LD_QP + 6 * (bd - 8),
                                 lam_i, ft["wts"], extra[:nb], tabs, bd,
                                 intra)
                            same("rd_cost_pred",
                                 f"{w}x{h} {bd}-bit {tag} rounding "
                                 f"{171 if intra else 85} B={nb}",
                                 rc.rd_cost_pred(*a),
                                 rc.rd_cost_pred_plain(*a))
            del blk8, prd8, pairs, pp, bb
    # K8: leaves of frame 1 against frame 0 in three sets, 16x16, 32x32
    # and 64x64 (4, 16 and 64 tiles a leaf, segment sums in tile order):
    # the 32x32 leaves at K7's 32x32 MVs, the others at seeded random
    # full-pel MVs; then the 64x64 set at the largest residual at 10 bits
    # (block = 1023 - window)
    k7 = {(w, h): (g, idx) for (w, h, g), (idx, *_r) in zip(iclasses, found)}
    pen49 = k8_pen(torch, dev)
    sets = {f"{s}x{s}": k8_tiles(torch, lv, frames[0][0], frames[1][0], dev)
            for s, lv in k8_leaves(k7.get((32, 32))).items()}
    cases = [(f"{tag} {bd}-bit", (wn * sc, bk * sc, ids, nl, pen49, bd))
             for tag, (wn, bk, ids, nl) in sets.items()
             for bd, sc in ((8, 1), (10, 4))]
    wins64, _b, ids64, nl64 = sets["64x64"]
    wmax = (wins64 % 2) * 1023
    cases.append(("64x64 10-bit max residual",
                  (wmax, 1023 - wmax[:, 5:13, 5:13].contiguous(), ids64, nl64,
                   pen49, 10)))
    for what, a in cases:
        for o, x_, y_ in zip(("best", "cost", "seg"), mf.leaf_qpel(*a),
                             mf.leaf_qpel_plain(*a)):
            same("leaf_qpel", f"{what} {o}", x_, y_)
        # the tile pass alone against the plain per-tile SATDs
        satd = torch.empty((a[0].shape[0], 49), dtype=torch.int32, device=dev)
        k8_tile_pass(kernels, a[0], a[1], a[2], pen49, a[5], satd)
        same("leaf_qpel", f"{what} tile SATDs", satd,
             mf._tile_satd_plain(a[0], a[1], a[5]).to(torch.int32))
    for tag in ("16x16", "64x64"):
        wins, blks, lids, li = sets[tag]
        nt = wins.shape[0]
        _k, k8_dev, _b = timed(
            "leaf_qpel", lambda: mf.leaf_qpel(wins, blks, lids, li, pen49, 8),
            lambda: mf.leaf_qpel_plain(wins, blks, lids, li, pen49, 8),
            f"{tag}: {nt} tiles, {li} leaves", account=tag == "16x16",
            B=0, w=8, h=8, H_=H, W_=W, nt=nt, nl=li)
        satd = torch.empty((nt, 49), dtype=torch.int32, device=dev)
        tile_dev = graph_ms(torch, lambda: k8_tile_pass(
            kernels, wins, blks, lids, pen49, 8, satd), 20)
        before = {p_: K78_BEFORE_MS[(f"leaf_qpel {tag}", p_)]
                  for p_ in ("whole", "tile")}
        print(f"  leaf_qpel {tag} by pass (device, graph): tile "
              f"{tile_dev:.4f} ms, segment {k8_dev - tile_dev:.4f} ms "
              f"(earlier design: whole {before['whole']:.4f}, tile "
              f"{before['tile']:.4f})", flush=True)
    del found, want, sets, cases, wins, blks, lids, wins64, ids64, wmax, satd
    print(f"phase 4 inter kernels: {checks - n0} comparisons, all equal",
          flush=True)

    # --- 4b. the kernels of the all-intra tool paths ------------------------
    stamp("4b")
    n0 = checks
    for (_key, w, h, positions, g) in entries:
        B = len(positions)
        xs = np.array([p[0] for p in positions], dtype=np.int32)
        ys = np.array([p[1] for p in positions], dtype=np.int32)
        size_id, n_modes, rb, rp, _uh, _uv = mp.mip_geometry(w, h)
        n_cand = 2 * n_modes
        mat = mip_matrix(size_id, "cuda")
        mbits = mip_mode_bits(n_cand, "cuda")
        mts = device_mts_tables(w, h, "cuda") if max(w, h) <= 32 else None
        for bd in (8, 10):
            mx = (1 << bd) - 1
            tabs = device_tables(w, h, bd, "cuda")
            for tag, src in class_planes(bd).items():
                what = f"{w}x{h} {bd}-bit {tag}"
                refs, blocks = ib.refs_blocks(src, xs, ys, w, h)
                pr_, pb = ib.refs_blocks_plain(src, xs, ys, w, h)
                same("refs_blocks", what + " refs", refs, pr_)
                same("refs_blocks", what + " blocks", blocks, pb)
                mpreds = mp.mip_preds(src, xs, ys, w, h, bd, mat)
                same("mip_preds", what, mpreds,
                     mp.mip_preds_plain(src, xs, ys, w, h, bd, mat))
                msatds = ib.satd67(mpreds, blocks)
                same("satd67", f"{what} M={n_cand}", msatds,
                     ib.satd67_plain(mpreds, blocks))
                preds = ib.predict67(refs, tabs)
                satds = ib.satd67(preds, blocks)
                for qp in (22, 37):
                    qps = qp + 6 * (bd - 8)
                    lam = float(np.float32(qp_to_lambda(qp)))
                    ft = frame_tables(qp, "cuda")
                    args = (mpreds, blocks, msatds, qps, lam, ft["wts"],
                            mbits, tabs, bd)
                    for o, a, b in zip(("best", "rd", "satd"),
                                       rc.rd_cost(*args),
                                       rc.rd_cost_plain(*args)):
                        same("rd_cost", f"{what} M={n_cand} qp{qp} {o}", a, b)
                    if mts is None:
                        continue
                    best = rc.rd_cost(preds, blocks, satds, qps, lam,
                                      ft["wts"], ft["mode_bits"], tabs, bd)[0]
                    pairs = [(preds[torch.arange(B, device=dev), best.long()],
                              blocks)]
                    if tag == "edge":
                        # the largest residual: a 32x32 10-bit block's SSD
                        # reaches 1024 * 1023^2, just below 2^30
                        pairs.append((torch.zeros_like(blocks),
                                      torch.full_like(blocks, mx)))
                    for k, (pp, bb) in enumerate(pairs):
                        a = (pp, bb, qps, lam, ft["wts"], mts, bd)
                        for o, x_, y_ in zip(("tr_idx", "cost", "dc_only"),
                                             rc.mts_search(*a),
                                             rc.mts_search_plain(*a)):
                            same("mts_search", f"{what} #{k} qp{qp} {o}",
                                 x_, y_)
        # times at the frame's inputs (8 bits, QP22), once per class
        tabs = device_tables(w, h, 8, "cuda")
        ft = frame_tables(QP, "cuda")
        lam = float(np.float32(qp_to_lambda(QP)))
        shape = dict(B=B, w=w, h=h, H_=H, W_=W)
        xd, yd = ib.positions_on(xs, ys, w, h, H, W, dev)
        k12a_out = [torch.empty((B, 780), dtype=torch.int32, device=dev),
                    torch.empty((B, h, w), dtype=torch.int32, device=dev)]

        def k12a_entry():
            kernels.launch("refs_blocks", dev, frame_src.data_ptr(), H, W,
                           xd.data_ptr(), yd.data_ptr(), B, w, h,
                           k12a_out[0].data_ptr(), k12a_out[1].data_ptr())
        timed("refs_blocks", lambda: ib.refs_blocks(frame_src, xs, ys, w, h),
              lambda: ib.refs_blocks_plain(frame_src, xs, ys, w, h),
              f"{w}x{h}", graph=k12a_entry, **shape)
        for o, a, b in zip(("refs", "blocks"), k12a_out,
                           ib.refs_blocks_plain(frame_src, xs, ys, w, h)):
            same("refs_blocks", f"{w}x{h} C entry {o}", a, b)
        del k12a_out
        k10_out = torch.empty((B, n_cand, h, w), dtype=torch.int32,
                              device=dev)

        def k10_entry():
            kernels.launch("mip_preds", dev, frame_src.data_ptr(), H, W,
                           xd.data_ptr(), yd.data_ptr(), B, w, h, 8,
                           mat.data_ptr(), k10_out.data_ptr())
        timed("mip_preds",
              lambda: mp.mip_preds(frame_src, xs, ys, w, h, 8, mat),
              lambda: mp.mip_preds_plain(frame_src, xs, ys, w, h, 8, mat),
              f"{w}x{h} {n_cand} candidates", graph=k10_entry, M=n_cand,
              geom=(n_modes, rb, rp), **shape)
        del xd, yd, k10_out
        refs, blocks = ib.refs_blocks(frame_src, xs, ys, w, h)
        mpreds = mp.mip_preds(frame_src, xs, ys, w, h, 8, mat)
        msatds = ib.satd67(mpreds, blocks)
        m_args = (mpreds, blocks, msatds, QP, lam, ft["wts"], mbits, tabs, 8)
        timed("satd67", lambda: ib.satd67(mpreds, blocks),
              lambda: ib.satd67_plain(mpreds, blocks), f"{w}x{h} M={n_cand}",
              account=False, M=n_cand, **shape)
        timed("rd_cost", lambda: rc.rd_cost(*m_args),
              lambda: rc.rd_cost_plain(*m_args), f"{w}x{h} M={n_cand}",
              account=False, M=n_cand, **shape)
        if mts is not None:
            preds = ib.predict67(refs, tabs)
            best = rc.rd_cost(preds, blocks, ib.satd67(preds, blocks), QP, lam,
                              ft["wts"], ft["mode_bits"], tabs, 8)[0]
            t_args = (preds[torch.arange(B, device=dev), best.long()], blocks,
                      QP, lam, ft["wts"], mts, 8)
            timed("mts_search", lambda: rc.mts_search(*t_args),
                  lambda: rc.mts_search_plain(*t_args), f"{w}x{h}",
                  keep=mts["mts_keep"], **shape)
            del preds, best, t_args
        del refs, blocks, mpreds, msatds, m_args
    # K10 and K11 at the BT/TT shapes: the class grid, 8 and 10 bits; K11 on
    # K4's winning prediction and on the largest residual
    for (w, h) in LATTICE_SHAPES:
        nx, ny = W // w, H // h
        xs = np.tile(np.arange(nx, dtype=np.int32) * w, ny)
        ys = np.repeat(np.arange(ny, dtype=np.int32) * h, nx)
        B = xs.size
        mat = mip_matrix(mp.mip_size_id(w, h), "cuda")
        mts = device_mts_tables(w, h, "cuda") if max(w, h) <= 32 else None
        for bd in (8, 10):
            mx = (1 << bd) - 1
            tabs = device_tables(w, h, bd, "cuda")
            for tag, src in class_planes(bd).items():
                what = f"{w}x{h} {bd}-bit {tag}"
                same("mip_preds", what,
                     mp.mip_preds(src, xs, ys, w, h, bd, mat),
                     mp.mip_preds_plain(src, xs, ys, w, h, bd, mat))
                refs, blocks = ib.refs_blocks(src, xs, ys, w, h)
                for o, a, b in zip(("refs", "blocks"), (refs, blocks),
                                   ib.refs_blocks_plain(src, xs, ys, w, h)):
                    same("refs_blocks", f"{what} {o}", a, b)
                if mts is None:
                    continue
                preds = ib.predict67(refs, tabs)
                ft = frame_tables(22, "cuda")
                lam = float(np.float32(qp_to_lambda(22)))
                best = rc.rd_cost(preds, blocks, ib.satd67(preds, blocks),
                                  22 + 6 * (bd - 8), lam, ft["wts"],
                                  ft["mode_bits"], tabs, bd)[0]
                pairs = [(preds[torch.arange(B, device=dev), best.long()],
                          blocks),
                         (torch.zeros_like(blocks),
                          torch.full_like(blocks, mx))]
                for k, (pp, bb) in enumerate(pairs):
                    for qp in (22, 37):
                        a = (pp, bb, qp + 6 * (bd - 8),
                             float(np.float32(qp_to_lambda(qp))),
                             frame_tables(qp, "cuda")["wts"], mts, bd)
                        for o, x_, y_ in zip(("tr_idx", "cost", "dc_only"),
                                             rc.mts_search(*a),
                                             rc.mts_search_plain(*a)):
                            same("mts_search", f"{what} #{k} qp{qp} {o}",
                                 x_, y_)
                del refs, blocks, preds, best, pairs
    earlier = {n: sum(v for k, v in EARLIER_MS.items() if k[0] == n)
               for n in ("mip_preds", "mts_search")}
    print("  K10/K11 per frame (device, graph, ms): " + ", ".join(
        f"{n} {dev_ms[n]:.4f} (earlier design {v:.4f})"
        for n, v in earlier.items()), flush=True)
    earlier = {n: sum(v for k, v in EARLIER_MS.items() if k[0] == n)
               for n in ("rd_cost_pred", "refs_blocks_grid", "refs_blocks")}
    print("  K6 per dense reference, K1 and K12a per frame (device, graph, "
          "ms): " + ", ".join(f"{n} {dev_ms[n]:.4f} (earlier design {v:.4f})"
                              for n, v in earlier.items()), flush=True)
    print(f"phase 4b tool kernels: {checks - n0} comparisons, all equal",
          flush=True)

    # --- 4c. the per-class inter search and the rough search ----------------
    stamp("4c")
    n0 = checks
    l10cfg = ld10_config(Config)
    ps10 = PartitionSearch(EncoderControl(l10cfg), l10cfg, qp=LD_QP,
                           is_intra=False)
    lo, hi = l10cfg.pu_depth_inter
    # search_combined's inter classes: the depths pu_depth_inter allows
    me_all = search_classes(ps10)
    me_cls = [c for c in me_all
              if lo <= (64 // max(c[0], c[1])).bit_length() - 1 <= hi]
    pen_me, fpen = me_penalties(qp_to_lambda(LD_QP, False), R, "cuda")
    frac_contract = {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
    print("phase 4c inter classes: " + ", ".join(
        f"{w}x{h} B={len(p)}" for (w, h, p) in me_cls), flush=True)

    def me_planes(bd):
        """(reference, source) pairs: frames 0 and 1 of the clip, a flat
        plane (every offset ties), the checkerboard against itself moved
        by (5, 3)."""
        sc = 1 << (bd - 8)
        flat = torch.full((H, W), ((1 << bd) - 1) // 3, dtype=torch.int32,
                          device=dev)
        ck = checker(bd)
        return {"frame": tuple(torch.from_numpy(frames[i][0] * sc).to(dev)
                               for i in (0, 1)),
                "flat": (flat, flat),
                "edge": (ck, ck.roll((3, 5), (0, 1)).contiguous())}

    def on_card(pos, w, h):
        return ib.positions_on([p[0] for p in pos], [p[1] for p in pos], w, h,
                               H, W, dev)

    def me_check(what, ref_p, src_p, xs_d, ys_d, w, h, bd, frac=True):
        blk = me.windows(src_p, xs_d, ys_d, w, h, 0).to(torch.int32)
        got = me.fullpel_search(ref_p, blk, xs_d, ys_d, R, pen_me, bd)
        want = me.fullpel_search_plain(ref_p, blk, xs_d, ys_d, R, pen_me)
        for o, a, b in zip(("mvx", "mvy", "cost"), got, want):
            same("fullpel_search", f"{what} {o}", a, b)
        if frac:
            a_ = (ref_p, blk, xs_d, ys_d, got[0], got[1], fpen, bd)
            want = me.frac_search_plain(*a_)
            for o, a, b in zip(("best", "preds", "costs"), me.frac_search(*a_),
                               want):
                same("frac_search", f"{what} {o}", a, b)
            # the winner form against the plain gather
            gathered = want[1][torch.arange(blk.shape[0], device=dev),
                               want[0].long()]
            for o, a, b in zip(("best", "pred", "costs"),
                               me.frac_search(*a_, winner_only=True),
                               (want[0], gathered, want[2])):
                same("frac_search", f"{what} winner {o}", a, b)
        return blk, got

    for (w, h, pos) in me_cls:
        xs_d, ys_d = on_card(pos, w, h)
        for bd in (8, 10):
            for tag, (ref_p, src_p) in me_planes(bd).items():
                me_check(f"{w}x{h} {bd}-bit {tag}", ref_p, src_p, xs_d, ys_d,
                         w, h, bd)
        # the blocks in reverse order: no two of a thread block side by
        # side (K9a reads a window each instead of their union)
        f0, f1 = me_planes(10)["frame"]
        me_check(f"{w}x{h} 10-bit frame reversed", f0, f1,
                 xs_d.flip(0).contiguous(), ys_d.flip(0).contiguous(), w, h,
                 10)
        # times at the 10-bit frame's inputs, once per class
        f0, f1 = me_planes(10)["frame"]
        blk, (mvx, mvy, _c) = me_check(f"{w}x{h} 10-bit frame (timed)", f0,
                                       f1, xs_d, ys_d, w, h, 10)
        shape = dict(B=len(pos), w=w, h=h, H_=H, W_=W)
        timed("fullpel_search",
              lambda: me.fullpel_search(f0, blk, xs_d, ys_d, R, pen_me, 10),
              lambda: me.fullpel_search_plain(f0, blk, xs_d, ys_d, R, pen_me),
              f"{w}x{h} 10-bit", **shape)
        f_args = (f0, blk, xs_d, ys_d, mvx, mvy, fpen, 10)
        # the winner form is the one search_inter_blocks launches: its times
        # are the row's; the contract form's are kept beside them
        timed("frac_search",
              lambda: me.frac_search(*f_args, winner_only=True),
              lambda: me.frac_search_plain(*f_args), f"{w}x{h} 10-bit winner",
              winner=True, **shape)
        c_ms, c_dev, c_bound = timed(
            "frac_search", lambda: me.frac_search(*f_args),
            lambda: me.frac_search_plain(*f_args), f"{w}x{h} 10-bit contract",
            account=False, **shape)
        for key, v in (("ms", c_ms), ("device_ms", c_dev),
                       ("bound_ms", c_bound)):
            frac_contract[key] += v
        del blk, f_args
    print("  K9 per reference (16x16 + 8x8 at 10 bits, ms): fullpel_search "
          f"{ms['fullpel_search']:.4f} (device {dev_ms['fullpel_search']:.4f})"
          f", earlier design {K9_BEFORE_MS['fullpel_search']:.4f}; frac_search "
          f"winner form {ms['frac_search']:.4f} (device "
          f"{dev_ms['frac_search']:.4f}), contract form "
          f"{frac_contract['ms']:.4f} (device "
          f"{frac_contract['device_ms']:.4f}), earlier design "
          f"{K9_BEFORE_MS['frac_search']:.4f}", flush=True)
    # K9a's exact sums at their largest: all-max 10-bit planes, every
    # class (4096 * 1023^2 < 2^32 at 64x64)
    mx10 = torch.full((H, W), 1023, dtype=torch.int32, device=dev)
    for (w, h, pos) in me_all:
        xs_d, ys_d = on_card(pos, w, h)
        me_check(f"{w}x{h} 10-bit all-max", mx10, mx10, xs_d, ys_d, w, h, 10)
    # the rough search at every class of the rough path
    m1 = rough_modes("cuda")
    rcfg = rough_config(Config)
    rough_cls = search_classes(PartitionSearch(EncoderControl(rcfg), rcfg,
                                               qp=QP))
    rough_shapes = [(w, h) for (w, h, _p) in rough_cls]
    k12c_stages = {st: {"device_ms": 0.0, "bound_ms": 0.0}
                   for st in ("rough_select", "rough_pick")}
    for (w, h, pos) in rough_cls:
        B = len(pos)
        xs = np.array([p[0] for p in pos], dtype=np.int32)
        ys = np.array([p[1] for p in pos], dtype=np.int32)
        for bd in (8, 10):
            tabs = device_tables(w, h, bd, "cuda")
            for tag, src in class_planes(bd).items():
                what = f"{w}x{h} {bd}-bit {tag}"
                refs, blocks = ib.refs_blocks(src, xs, ys, w, h)
                p1 = ib.predict67(refs, tabs, m1)
                same("predict67", what + " M=35", p1,
                     ib.predict67_plain(refs, tabs, m1))
                s1 = ib.satd67(p1, blocks)
                for qp in (22, 37):
                    qps = qp + 6 * (bd - 8)
                    lam = float(np.float32(qp_to_lambda(qp)))
                    ft = frame_tables(qp, "cuda")
                    r_args = (refs, blocks, qps, lam, ft["wts"],
                              ft["mode_bits"], tabs, bd, m1)
                    for o, a, b in zip(("best_mode", "rd", "satd_best"),
                                       rc.rough_refine(*r_args),
                                       rc.rough_refine_plain(*r_args)):
                        same("rough_refine", f"{what} qp{qp} {o}", a, b)
                refine = rc.rough_select(s1, lam, ft["mode_bits"], m1)
                same("rough_refine", what + " refine", refine,
                     rc.rough_select_plain(s1, lam, ft["mode_bits"], m1))
                rand = torch.randint(2, 67, (B, 4), generator=gen,
                                     device=dev, dtype=torch.int32)
                rand[0] = torch.tensor([2, 66, 2, 66], dtype=torch.int32)
                # modes outside [2, 66] (clamped) and repeated ones
                wide = torch.randint(-3, 81, (B, 4), generator=gen,
                                     device=dev, dtype=torch.int32)
                wide[0] = torch.tensor([-1, 0, 1, 67], dtype=torch.int32)
                wide[-1] = torch.tensor([80, 80, 34, 34], dtype=torch.int32)
                for ltag, ml in (("refine", refine), ("random", rand),
                                 ("clamped", wide)):
                    same("predict_modes", f"{what} {ltag}",
                         ib.predict_modes(refs, ml, tabs),
                         ib.predict_modes_plain(refs, ml, tabs))
                # stage 2 alone on the class's predictions and SATDs
                p2 = ib.predict_modes(refs, refine, tabs)
                pk = (s1, ib.satd67(p2, blocks), refine, lam,
                      ft["mode_bits"], m1, p1, p2)
                for o, a, b in zip(("best_mode", "satd_best", "extra",
                                    "pred"), rc.rough_pick(*pk),
                                   rc.rough_pick_plain(*pk)):
                    same("rough_refine", f"{what} pick {o}", a, b)
                del p2, pk
        # times at the frame's inputs (8 bits, QP22), once per class
        tabs = device_tables(w, h, 8, "cuda")
        ft = frame_tables(QP, "cuda")
        lam = float(np.float32(qp_to_lambda(QP)))
        refs, blocks = ib.refs_blocks(frame_src, xs, ys, w, h)
        r_args = (refs, blocks, QP, lam, ft["wts"], ft["mode_bits"], tabs, 8,
                  m1)
        refine = rc.rough_select(ib.satd67(ib.predict67(refs, tabs, m1),
                                           blocks), lam, ft["mode_bits"], m1)
        shape = dict(B=B, w=w, h=h, H_=H, W_=W,
                     ref_samples=ref_samples(mode_reads(w, h), refine))
        timed("predict_modes", lambda: ib.predict_modes(refs, refine, tabs),
              lambda: ib.predict_modes_plain(refs, refine, tabs), f"{w}x{h}",
              R=4, **shape)
        timed("rough_refine", lambda: rc.rough_refine(*r_args),
              lambda: rc.rough_refine_plain(*r_args), f"{w}x{h}", **shape)
        # the two selection stages alone on the graph
        p1 = ib.predict67(refs, tabs, m1)
        s1 = ib.satd67(p1, blocks)
        p2 = ib.predict_modes(refs, refine, tabs)
        pk = (s1, ib.satd67(p2, blocks), refine, lam, ft["mode_bits"], m1,
              p1, p2)
        for st, fn in (("rough_select", lambda: rc.rough_select(
                s1, lam, ft["mode_bits"], m1)),
                       ("rough_pick", lambda: rc.rough_pick(*pk))):
            b, o = work(st, B, w, h, H, W)
            k12c_stages[st]["device_ms"] += graph_ms(torch, fn, 20)
            k12c_stages[st]["bound_ms"] += max(b / HBM_BYTES_PER_S,
                                               o / OPS_PER_S) * 1e3
        del refs, blocks, refine, r_args, p1, s1, p2, pk
    print("  K12c stages a frame on the graph (ms): " + ", ".join(
        f"{st} {v['device_ms']:.4f} (bound {v['bound_ms']:.4f}, earlier "
        f"design {K12C_BEFORE_MS[st]:.4f})" for st, v in k12c_stages.items()),
        flush=True)
    # the two stages alone on crafted ties (rough_stage_cases), B = 1, 37
    # and 6240, the real and flat mode bits: stage 1, then stage 2 at each
    # rough class's h*w on numbered predictions (a wrong gather shows)
    lam = float(np.float32(qp_to_lambda(QP)))
    bits = {"bits": frame_tables(QP, "cuda")["mode_bits"],
            "flat bits": torch.ones(67, device=dev)}
    for Bc in (1, 37, 6240):
        cases = []
        for tag, *arrs in rough_stage_cases(Bc, seed=Bc):
            s1, s2, refine = (None if a is None else
                              torch.from_numpy(a).to(dev) for a in arrs)
            for btag, mb in bits.items():
                what = f"B={Bc} {tag} {btag}"
                got = rc.rough_select(s1, lam, mb, m1)
                same("rough_refine", f"{what} select", got,
                     rc.rough_select_plain(s1, lam, mb, m1))
                cases.append((what, (s1, s2, got if refine is None else
                                     refine, lam, mb, m1)))
        for (w, h) in rough_shapes:
            p1 = torch.arange(Bc * 35 * h * w, dtype=torch.int32,
                              device=dev).view(Bc, 35, h, w)
            p2 = -1 - torch.arange(Bc * 4 * h * w, dtype=torch.int32,
                                   device=dev).view(Bc, 4, h, w)
            for what, pk in cases:
                for o, a, b in zip(("best_mode", "satd_best", "extra",
                                    "pred"), rc.rough_pick(*pk, p1, p2),
                                   rc.rough_pick_plain(*pk, p1, p2)):
                    same("rough_refine", f"{w}x{h} {what} pick {o}", a, b)
            del p1, p2
    print(f"phase 4c per-class inter and rough kernels: {checks - n0} "
          "comparisons, all equal", flush=True)

    counts = {}

    def expect(path, launches, want_counts):
        for name in REPLACES:
            if launches.get(name, 0) != want_counts.get(name, 0):
                fail(f"{path} path launched {name} {launches.get(name, 0)} "
                     f"times, expected {want_counts.get(name, 0)}")
        counts[path] = launches

    def n_classes(enc):
        return len(enc.slice_enc._fused_entries_c)

    def native(path, enc):
        # a failed g++ build of native/ would fall back to the Python
        # entropy engine and only show as a slow run
        if not enc.slice_enc.native_entropy:
            fail(f"{path} path: the native entropy library did not build")

    # --- 5. the all-intra path ----------------------------------------------
    stamp("5")
    clip = [FramePlanes(*f) for f in frames]
    encode(Encoder(cfg, device=dev), FramePlanes, clip[:2])    # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    enc = Encoder(cfg, device=dev)
    outs = encode(enc, FramePlanes, clip)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    native("all-intra", enc)
    if len(outs) != FRAMES:
        fail(f"all-intra path returned {len(outs)} of {FRAMES} frames")
    expect("all-intra", launches,
           dict.fromkeys(INTRA_KERNELS, n_classes(enc) * FRAMES))
    for au, rec, _fs, _refs, _src in outs:
        if not au or rec.y.shape != (H, W) or not np.isfinite(rec.y).all():
            fail("all-intra path produced an empty AU or a malformed recon")
    print(f"phase 5 all-intra path: {FRAMES} frames {W}x{H} QP{QP} in "
          f"{wall:.3f} s = {FRAMES / wall:.3f} fps wall, "
          f"{sum(len(o[0]) for o in outs)} bytes, launches "
          + json.dumps(launches), flush=True)
    print(busy_share(torch, lambda: encode(Encoder(cfg, device=dev),
                                           FramePlanes, clip)), flush=True)

    # --- 6. the low-delay path ----------------------------------------------
    stamp("6")
    lcfg = ld_config(Config)
    seq = [clip[i % FRAMES] for i in range(LD_FRAMES)]
    encode(Encoder(lcfg, device=dev), FramePlanes, seq[:3])     # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    lenc = Encoder(lcfg, device=dev)
    louts = encode(lenc, FramePlanes, seq)
    torch.cuda.synchronize()
    lwall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    native("low-delay", lenc)
    if len(louts) != LD_FRAMES:
        fail(f"low-delay path returned {len(louts)} of {LD_FRAMES} frames")
    n_p = sum(1 for o in louts if o[2].slicetype != SliceType.I)
    if n_p != LD_FRAMES - 1:
        fail(f"low-delay path coded {n_p} P/B frames, expected "
             f"{LD_FRAMES - 1}")
    expect("low-delay", launches,
           {**dict.fromkeys(INTRA_KERNELS, n_classes(lenc) * LD_FRAMES),
            "pseudo_recon": n_p})
    print(f"phase 6 low-delay path: {LD_FRAMES} frames {W}x{H} QP{LD_QP} "
          f"({n_p} P/B) in {lwall:.3f} s = {LD_FRAMES / lwall:.3f} fps wall, "
          f"{sum(len(o[0]) for o in louts)} bytes, launches "
          + json.dumps(launches), flush=True)
    print(busy_share(torch, lambda: encode(Encoder(lcfg, device=dev),
                                           FramePlanes, seq)), flush=True)

    refine = SliceEncoder._refine_inter_leaves

    def counting_k8(run):
        """run() with a count of the frames that give K8 inter leaves to
        refine (it launches once for each) -> (run's result, count)."""
        n = [0]

        def counted_refine(self, ctus, *a, **k):
            if any(leaf.cu_desc.get("type") == "inter"
                   for node in ctus for leaf in node.leaves()):
                n[0] += 1
            return refine(self, ctus, *a, **k)
        SliceEncoder._refine_inter_leaves = counted_refine
        try:
            return run(), n[0]
        finally:
            SliceEncoder._refine_inter_leaves = refine

    def profiled(run):
        """run() under the profiler (one encode gives both its wall and
        its device busy time) -> (run's result, the busy line with every
        kernel)."""
        got = {}
        busy = busy_share(torch, lambda: got.setdefault("r", run()),
                          every=True)
        return got["r"], busy

    def timed_encode(pcfg, pclip):
        kernels.reset_launches()
        t0 = time.perf_counter()
        penc = Encoder(pcfg, device=dev)
        pouts = encode(penc, FramePlanes, pclip)
        torch.cuda.synchronize()
        return penc, pouts, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    # --- 6b. the low-delay path with rdoq on --------------------------------
    stamp("6b")
    qcfg = rdoq_ld_config(Config)
    qseq = clip[:RDOQ_FRAMES]
    encode(Encoder(qcfg, device=dev), FramePlanes, qseq[:2])    # warm-up
    torch.cuda.synchronize()
    ((qenc, qouts, qwall, launches), k8_q), qbusy = profiled(
        lambda: counting_k8(lambda: timed_encode(qcfg, qseq)))
    native("rdoq LD", qenc)
    if len(qouts) != RDOQ_FRAMES:
        fail(f"rdoq LD path returned {len(qouts)} of {RDOQ_FRAMES} frames")
    n_p = sum(1 for o in qouts if o[2].slicetype != SliceType.I)
    if k8_q == 0:
        fail("rdoq LD path: no inter leaf refined")
    expect("rdoq LD", launches,
           {**dict.fromkeys(INTRA_KERNELS, n_classes(qenc) * RDOQ_FRAMES),
            "pseudo_recon": n_p, "leaf_qpel": k8_q})
    print(f"phase 6b rdoq LD path: {RDOQ_FRAMES} frames {W}x{H} QP{LD_QP} "
          f"({n_p} P/B, {k8_q} with inter leaves) in {qwall:.3f} s = "
          f"{RDOQ_FRAMES / qwall:.3f} fps wall (profiled), "
          f"{sum(len(o[0]) for o in qouts)} bytes, launches "
          + json.dumps(launches), flush=True)
    print(qbusy, flush=True)

    # --- 7. the dense inter path --------------------------------------------
    stamp("7")
    rclip = clip[:RA_FRAMES]
    ((denc, douts, dwall, launches), k8_d), dbusy = profiled(
        lambda: counting_k8(lambda: timed_encode(dcfg, rclip)))
    native("dense RA", denc)
    if len(douts) != RA_FRAMES:
        fail(f"dense path returned {len(douts)} of {RA_FRAMES} frames")
    n_uniq = 0
    for (_au, _rec, fs, rl, _src) in douts:
        if fs.slicetype != SliceType.I:
            rl = rl if isinstance(rl, RefLists) else RefLists.from_single(
                rl, fs)
            n_uniq += len(denc.slice_enc._uniq_refs(
                rl, fs.slicetype == SliceType.B)[0])
    if n_uniq == 0 or k8_d == 0:
        fail("dense path: no inter frame searched or refined")
    expect("dense RA", launches,
           {**dict.fromkeys(INTRA_KERNELS, n_classes(denc) * RA_FRAMES),
            "frame_inter": n_uniq,
            "rd_cost_pred": n_uniq * len(inter_classes(
                denc.slice_enc, denc.slice_enc._fused_entries_c)),
            "leaf_qpel": k8_d})
    print(f"phase 7 dense path: {RA_FRAMES} frames {W}x{H} QP{LD_QP} RA GOP8 "
          f"ime_algorithm=2 rdoq in {dwall:.3f} s = {RA_FRAMES / dwall:.3f} "
          f"fps wall (profiled), {sum(len(o[0]) for o in douts)} bytes, "
          "launches " + json.dumps(launches), flush=True)
    print(dbusy, flush=True)

    # --- 7b. the MIP and MTS paths ------------------------------------------
    stamp("7b")
    mcfg, tcfg = mip_config(Config), mts_config(Config)
    tclip = clip[:TOOL_FRAMES]
    # every class dispatch_blocks / search_blocks is called for
    tool_classes = search_classes(PartitionSearch(ctrl, cfg, qp=QP))
    n_cls = len(tool_classes)
    n_mts = sum(1 for (w, h, _p) in tool_classes if max(w, h) <= 32)
    tool_outs = {}
    for path, pcfg, per_frame in (
            ("MIP", mcfg, {"refs_blocks_grid": n_cls, "predict67": n_cls,
                           "satd67": 2 * n_cls, "rd_cost": 2 * n_cls,
                           "mip_preds": n_cls, "refs_blocks": n_cls}),
            ("MTS", tcfg, {"predict67": n_cls, "satd67": n_cls,
                           "rd_cost": n_cls, "mts_search": n_mts})):
        (penc, pouts, pwall, launches), pbusy = profiled(
            lambda: timed_encode(pcfg, tclip))
        native(path, penc)
        if len(pouts) != TOOL_FRAMES:
            fail(f"{path} path returned {len(pouts)} of {TOOL_FRAMES} frames")
        expect(path, launches,
               {k: v * TOOL_FRAMES for k, v in per_frame.items()})
        for au, rec, _fs, _refs, _src in pouts:
            if not au or rec.y.shape != (H, W) or not np.isfinite(rec.y).all():
                fail(f"{path} path produced an empty AU or a malformed recon")
        tool_outs[path] = pouts
        print(f"phase 7b {path} path: {TOOL_FRAMES} frames {W}x{H} QP{QP} "
              f"all-intra, {n_cls} classes ({n_mts} up to 32x32), in "
              f"{pwall:.3f} s = {TOOL_FRAMES / pwall:.3f} fps wall "
              f"(profiled), {sum(len(o[0]) for o in pouts)} bytes, launches "
              + json.dumps(launches), flush=True)
        print(pbusy, flush=True)

    # --- 7c. the per-class inter search and the rough search paths ---------
    stamp("7c")
    def run_path(path, pcfg, pclip, warm):
        encode(Encoder(pcfg, device=dev), FramePlanes, pclip[:warm])
        torch.cuda.synchronize()
        (penc, pouts, pwall, launches), pbusy = profiled(
            lambda: timed_encode(pcfg, pclip))
        native(path, penc)
        if len(pouts) != len(pclip):
            fail(f"{path} path returned {len(pouts)} of {len(pclip)} frames")
        for au, rec, _fs, _refs, _src in pouts:
            if not au or rec.y.shape != (H, W) or not np.isfinite(rec.y).all():
                fail(f"{path} path produced an empty AU or a malformed recon")
        return penc, pouts, pwall, launches, pbusy

    def combined_counts(penc, pouts, pcfg):
        """Launches of a configuration whose P/B frames run search_combined
        per class: search_blocks everywhere (K2, K3, K4, and K11 up to
        32x32 with MTS), K9a, K9b and K6 per inter class and unique
        reference, one more K6 per inter class of a B slice (bipred); an I
        frame without MTS takes the fused all-intra search (K1-K4)."""
        classes = search_classes(PartitionSearch(penc.ctrl, pcfg, qp=LD_QP))
        lo_, hi_ = pcfg.pu_depth_inter
        n_c = len(classes)
        n_i = sum(1 for (w, h, _p) in classes
                  if lo_ <= (64 // max(w, h)).bit_length() - 1 <= hi_)
        n_t = sum(1 for (w, h, _p) in classes if max(w, h) <= 32)
        mts = pcfg.mts in (1, 3)
        want = {}

        def add(k, v):
            want[k] = want.get(k, 0) + v
        for (_au, _rec, fs, rl, _src) in pouts:
            if fs.slicetype == SliceType.I and not mts:
                for k in INTRA_KERNELS:
                    add(k, n_c)
                continue
            for k in ("predict67", "satd67", "rd_cost"):
                add(k, n_c)
            if mts:
                add("mts_search", n_t)
            if fs.slicetype == SliceType.I:
                continue
            is_b = fs.slicetype == SliceType.B
            rl = rl if isinstance(rl, RefLists) else RefLists.from_single(
                rl, fs)
            n_u = len(penc.slice_enc._uniq_refs(rl, is_b)[0])
            add("fullpel_search", n_i * n_u)
            add("frac_search", n_i * n_u)
            add("rd_cost_pred", n_i * (n_u + (1 if is_b and n_u else 0)))
        return want

    per_class = {}
    l10cfg = ld10_config(Config)
    sra_cfg = slow_ra_config(Config)
    clip10 = clip_for(l10cfg, frames[:LD10_FRAMES])
    for path, pcfg, pclip, warm in (
            ("10-bit LD", l10cfg, clip10, 2),
            ("slow RA", sra_cfg, frames[:RA_FRAMES], 2),
            ("rough", rcfg, frames[:ROUGH_FRAMES], 1)):
        penc, pouts, pwall, launches, pbusy = run_path(path, pcfg, pclip,
                                                       warm)
        if path == "rough":
            n_r = len(search_classes(PartitionSearch(ctrl, rcfg, qp=QP)))
            want = {k: v * n_r * ROUGH_FRAMES for k, v in (
                ("refs_blocks", 1), ("predict67", 1), ("satd67", 2),
                ("predict_modes", 1), ("rough_refine", 2),
                ("rd_cost_pred", 1))}
        else:
            want = combined_counts(penc, pouts, pcfg)
            if not want.get("fullpel_search"):
                fail(f"{path} path: no inter class searched")
        if path == "slow RA" and not any(o[2].slicetype == SliceType.B
                                         for o in pouts):
            fail("slow RA path coded no B slice")
        expect(path, launches, want)
        per_class[path] = pouts
        types = "".join(SLICE[o[2].slicetype] for o in pouts)
        print(f"phase 7c {path} path: {len(pclip)} frames {W}x{H} "
              f"{pcfg.input_bitdepth}-bit QP{pcfg.qp} ({types}) in "
              f"{pwall:.3f} s = {len(pclip) / pwall:.3f} fps wall "
              f"(profiled), {sum(len(o[0]) for o in pouts)} bytes, launches "
              + json.dumps(launches), flush=True)
        print(pbusy, flush=True)

    # --- 8. the card against the CPU ----------------------------------------
    stamp("8")
    cpu8_ref = cpu_half(cpu8, 8)

    def card_vs_cpu(path, got, n, ref):
        """The card's first n frames against the CPU path's: ref, its
        (access unit, recon digest) per frame from the child processes."""
        if len(ref) < n:
            fail(f"{path}: the CPU path gave {len(ref)} of {n} frames")
        for i in range(n):
            if got[i][0] != ref[i][0] or recon_digest(got[i][1]) != ref[i][1]:
                fail(f"{path}: coded frame {i} (poc {got[i][2].poc}) differs "
                     "between the card and the CPU")
        return ", ".join(f"{SLICE[got[i][2].slicetype]} poc {got[i][2].poc} "
                         f"{len(got[i][0])} B" for i in range(n))

    msg = [card_vs_cpu(p, got, n, cpu8_ref[p]) for p, got, n in (
        ("all-intra", outs, 1), ("low-delay", louts, 3),
        ("rdoq LD", qouts, 2))]
    # three frames of the dense path: the IDR, then the truncated GOP's
    # POC 2 (P) and POC 1 (B)
    dshort = encode(Encoder(dcfg, device=dev), FramePlanes, rclip[:3])
    msg.append(card_vs_cpu("dense RA", dshort, 3, cpu8_ref["dense RA"]))
    if {o[2].slicetype for o in dshort} != {SliceType.I, SliceType.P,
                                             SliceType.B}:
        fail("dense RA card-vs-CPU clip lacks an I, P or B slice")
    msg += [card_vs_cpu(p, got, n, cpu8_ref[p]) for p, got, n in (
        ("MIP", tool_outs["MIP"], 1), ("MTS", tool_outs["MTS"], 1),
        ("10-bit LD", per_class["10-bit LD"], 2))]
    # three frames of the slow-tools RA path: the IDR, POC 2 (P), POC 1 (B)
    sshort = encode(Encoder(sra_cfg, device=dev), FramePlanes, rclip[:3])
    if {o[2].slicetype for o in sshort} != {SliceType.I, SliceType.P,
                                             SliceType.B}:
        fail("slow RA card-vs-CPU clip lacks an I, P or B slice")
    msg.append(card_vs_cpu("slow RA", sshort, 3, cpu8_ref["slow RA"]))
    msg.append(card_vs_cpu("rough", per_class["rough"], 1,
                           cpu8_ref["rough"]))
    # the LD path at 136x72: its plane pads to 144x80, so K5's last thread
    # block holds one tile, and the last CTU row is partial
    s_cfg = ld_config(Config, 136, 72)
    s_clip = [FramePlanes(*f) for f in synth_clip(136, 72, 3)]
    n_k5 = kernels.LAUNCHES["pseudo_recon"]
    s_outs = encode(Encoder(s_cfg, device=dev), FramePlanes, s_clip)
    if kernels.LAUNCHES["pseudo_recon"] - n_k5 != 2:
        fail("LD 136x72: K5 did not launch once per P frame")
    msg.append(card_vs_cpu("LD 136x72", s_outs, 3, cpu8_ref["LD 136x72"]))
    print("phase 8 card vs CPU byte-identical: " + "; ".join(msg), flush=True)

    # --- 9. the mesh encoders, the CLI and the entry points ----------------
    stamp("9")
    from uvg266_tpu_torch import graft_entry
    from uvg266_tpu_torch.oracle.ref_decoder import decode_stream
    from uvg266_tpu_torch.parallel import (MeshEncoder, MeshGopEncoder,
                                           build_gop_mesh, build_mesh)
    n0 = checks
    mesh_counts = {}

    def same_bytes(what, a, b):
        nonlocal checks
        checks += 1
        if a != b:
            fail(f"{what}: differs")

    def same_recon(what, a, b):
        for p in ("y", "u", "v"):
            same_bytes(f"{what} recon {p}", np.asarray(getattr(a, p)).tobytes(),
                       np.asarray(getattr(b, p)).tobytes())

    def mesh_intra(label, mcfg_, mclip, per_batch, per_frame):
        """MeshEncoder on the (2, 4) mesh against the plain Encoder, both on
        the card: AUs and recons equal, launches as given."""
        mesh = build_mesh(8, device=dev)
        if mesh.shape != {"gop": 2, "tile": 4}:
            fail(f"9a {label}: mesh {mesh.shape}")
        MeshEncoder(mcfg_, mesh).encode(mclip[:2])                # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        menc = MeshEncoder(mcfg_, mesh)
        got = menc.encode(mclip)
        torch.cuda.synchronize()
        mwall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n_cls = sum(1 for cl in menc._search_classes()[1]
                    if cl["positions"])
        batches = len(mclip) // 2
        expect(f"mesh {label}", launches,
               {k: v * n_cls * batches for k, v in per_batch.items()})
        mesh_counts[f"mesh {label}"] = launches
        kernels.reset_launches()
        t0 = time.perf_counter()
        ref = encode(Encoder(mcfg_, device=dev), FramePlanes, mclip)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
        expect(f"plain {label}", dict(kernels.LAUNCHES),
               {k: v * n_cls * len(mclip) for k, v in per_frame.items()})
        if not len(got) == len(ref) == len(mclip):
            fail(f"9a {label}: {len(got)} mesh and {len(ref)} plain frames")
        for i, ((au_m, rec_m), (au_p, rec_p, *_r)) in enumerate(zip(got, ref)):
            same_bytes(f"9a {label} frame {i} AU", au_m, au_p)
            same_recon(f"9a {label} frame {i}", rec_m, rec_p)
        if len(menc.frame_rd_stats) != len(mclip) or \
                not all(v > 0 for v in menc.frame_rd_stats):
            fail(f"9a {label}: frame RD stats {menc.frame_rd_stats}")
        print(f"phase 9a mesh {label}: {len(mclip)} frames {W}x{H} "
              f"QP{mcfg_.qp}, mesh (gop 2, tile 4), {n_cls} classes, in "
              f"{mwall:.3f} s = {len(mclip) / mwall:.3f} fps wall (plain "
              f"{pwall:.3f} s = {len(mclip) / pwall:.3f} fps), "
              f"{sum(len(a) for a, _r in got)} bytes equal the plain "
              f"encode's, frame RD "
              + ", ".join(f"{v:.1f}" for v in menc.frame_rd_stats)
              + ", launches " + json.dumps(launches), flush=True)
        print(busy_share(torch, lambda: MeshEncoder(mcfg_, mesh).encode(
            mclip), every=True), flush=True)

    tcfg_ = dataclasses.replace(cfg, tiles_width_count=2, tiles_height_count=2,
                                wpp=False)
    mesh_intra("all-intra", tcfg_, clip[:4],
               dict.fromkeys(INTRA_KERNELS, 1), dict.fromkeys(INTRA_KERNELS, 1))
    mesh_intra("MIP", dataclasses.replace(tcfg_, mip=True), clip[:2],
               {"refs_blocks_grid": 1, "predict67": 1, "satd67": 2,
                "rd_cost": 2, "mip_preds": 2},
               {"refs_blocks_grid": 1, "predict67": 1, "satd67": 2,
                "rd_cost": 2, "mip_preds": 1, "refs_blocks": 1})

    # 9b: closed-GOP runs in lockstep, every step one batched call
    gcfg = ld_config(Config)
    G_, L_ = 2, 4
    gclip = clip[:G_ * L_]
    gmesh = build_gop_mesh(G_, device=dev)
    MeshGopEncoder(gcfg, gmesh).encode(gclip[:G_ * 2])           # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    genc = MeshGopEncoder(gcfg, gmesh)
    gres = genc.encode(gclip)
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_cls_g = n_classes(genc.encs[0])
    if genc.disp.n_batched != L_ or genc.disp.n_fallback:
        fail(f"9b: {genc.disp.n_batched} batched calls (expected {L_}), "
             f"{genc.disp.n_fallback} fallbacks")
    expect("gop mesh", launches,
           {**dict.fromkeys(INTRA_KERNELS, n_cls_g * L_),
            "pseudo_recon": L_ - 1})
    mesh_counts["gop mesh"] = launches
    for g in range(G_):
        ref = encode(Encoder(gcfg, device=dev), FramePlanes,
                     gclip[g * L_:(g + 1) * L_])
        if not len(gres[g]) == len(ref) == L_:
            fail(f"9b run {g}: {len(gres[g])} mesh and {len(ref)} plain frames")
        for i, (a, b) in enumerate(zip(gres[g], ref)):
            same_bytes(f"9b run {g} frame {i} AU", a[0], b[0])
            same_recon(f"9b run {g} frame {i}", a[1], b[1])
    print(f"phase 9b gop mesh: {G_} runs of {L_} frames {W}x{H} QP{LD_QP} "
          f"LD in {gwall:.3f} s = {G_ * L_ / gwall:.3f} fps wall, "
          f"{genc.disp.n_batched} batched calls, {genc.disp.n_fallback} "
          f"fallbacks, {sum(len(o[0]) for r in gres for o in r)} bytes equal "
          "two plain encodes', launches " + json.dumps(launches), flush=True)
    print(busy_share(torch, lambda: MeshGopEncoder(gcfg, gmesh).encode(gclip),
                     every=True), flush=True)

    # 9b's wall against the same 8 frames through two plain Encoders (one
    # after the other) and through the gop mesh with its dispatcher unset
    # (the runs' host threads alone), in the order a b c c b a
    def gop_mesh(dispatch):
        m = MeshGopEncoder(gcfg, gmesh)
        if not dispatch:
            for e in m.encs:
                e.slice_enc._mesh_dispatch = None
        return lambda: m.encode(gclip)

    def plain_runs():
        for g in range(G_):
            encode(Encoder(gcfg, device=dev), FramePlanes,
                   gclip[g * L_:(g + 1) * L_])

    walls = {"gop mesh": [], "gop mesh, dispatcher unset": [],
             "two plain Encoders": []}
    for label in ("gop mesh", "gop mesh, dispatcher unset",
                  "two plain Encoders", "two plain Encoders",
                  "gop mesh, dispatcher unset", "gop mesh"):
        run = plain_runs if label == "two plain Encoders" \
            else gop_mesh(label == "gop mesh")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls[label].append(time.perf_counter() - t0)
    print(f"phase 9b walls, {G_ * L_} frames {W}x{H} QP{LD_QP} LD, order "
          "a b c c b a: " + "; ".join(
              f"{k} " + ", ".join(f"{t} s = {G_ * L_ / t} fps" for t in v)
              for k, v in walls.items()), flush=True)

    # the batched call alone at the main path's size: G = 2 slots at one
    # QP and at two, each row against the slot's own call on the card and
    # the plain versions on the CPU (K5 over a group's planes as one plane
    # of 2H rows, K1 over both planes with the pseudo-recon references),
    # tolerance 0; K1-K3 once per class, K4 (and K5) once per QP group
    from uvg266_tpu_torch.control.encoder import (_get_frame_combo_fn,
                                                  _get_pframe_intra_combo_fn)
    from uvg266_tpu_torch.control.partition import qp_to_lambda
    from uvg266_tpu_torch.ops.tables import frame_tables
    from uvg266_tpu_torch.parallel.mesh import _MeshGroupDispatch
    n1 = checks
    ctrl_g = genc.encs[0].ctrl
    classes_g = tuple((w_, h_, g_) for (_k, w_, h_, _p, g_)
                      in genc.encs[0].slice_enc._fused_entries_c)
    planes_g = [np.ascontiguousarray(f.y, dtype=np.int32) for f in gclip[:2]]
    disp = _MeshGroupDispatch(gmesh, 2)
    for req in ("pframe_intra", "frame_intra"):
        intra = req == "frame_intra"
        if intra:
            gkey = (req, classes_g, 8)
            fn = _get_frame_combo_fn(classes_g, 8)
        else:
            gkey = (req, classes_g, H, W, 8)
            fn = _get_pframe_intra_combo_fn(classes_g, H, W, 8)
        singles = {}

        def single(s, q, where):
            if (s, q, where) not in singles:
                tabs = frame_tables(q, str(where))
                singles[s, q, where] = fn(
                    torch.from_numpy(planes_g[s]).to(where),
                    ctrl_g.luma_qp_scaled(q),
                    float(np.float32(qp_to_lambda(q, intra))), tabs["wts"],
                    tabs["mode_bits"]).cpu().numpy()
            return singles[s, q, where]

        for qps_ in ((LD_QP, LD_QP), (LD_QP, LD_QP + 5)):
            n_grp = len(set(qps_))
            kernels.reset_launches()
            rows = disp._batched(gkey, [
                (planes_g[s], ctrl_g.luma_qp_scaled(q),
                 float(np.float32(qp_to_lambda(q, intra))), q)
                for s, q in enumerate(qps_)])
            torch.cuda.synchronize()
            expect(f"9b batched {req} QPs {qps_}", dict(kernels.LAUNCHES),
                   {"refs_blocks_grid": len(classes_g),
                    "predict67": len(classes_g), "satd67": len(classes_g),
                    "rd_cost": len(classes_g) * n_grp,
                    "pseudo_recon": 0 if intra else n_grp})
            for s, q in enumerate(qps_):
                for where in (dev, "cpu"):
                    checks += 1
                    want = single(s, q, where)
                    if rows[s].shape != want.shape or \
                            not np.array_equal(rows[s], want):
                        fail(f"9b batched {req} QPs {qps_} slot {s}: the row "
                             f"differs from the slot's own call on {where}")
    print(f"phase 9b batched call at {W}x{H}, G = 2, one and two QP groups, "
          f"{len(classes_g)} classes: {checks - n1} rows equal the slots' own "
          "calls on the card and the plain versions on the CPU", flush=True)

    # 9c: the CLI on the card in a subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as td:
        y4m, vvc = os.path.join(td, "clip.y4m"), os.path.join(td, "out.vvc")
        with open(y4m, "wb") as fh:
            fh.write(f"YUV4MPEG2 W{W} H{H} F30:1 Ip C420jpeg\n".encode())
            for (y, u, v) in frames[:3]:
                fh.write(b"FRAME\n")
                for pl in (y, u, v):
                    fh.write(pl.astype(np.uint8).tobytes())
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "uvg266_tpu_torch.tools.encode", "-i", y4m,
                            "-o", vvc, "-p", "1", "-q", str(QP), "--device",
                            "cuda", "--verify"], cwd=repo, capture_output=True,
                           text=True, timeout=600)
        cwall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"9c CLI exit {r.returncode}: {r.stderr[-2000:]}")
        with open(vvc, "rb") as fh:
            stream = fh.read()
    # the Config the CLI builds for "-p 1 -q QP" (tools/encode.py)
    ccfg = Config(width=W, height=H, qp=QP, input_bitdepth=8, gop_len=0,
                  gop_lowdelay=True, intra_period=1, bipred=0,
                  tmvp_enable=False, target_bitrate=0, vaq=0,
                  ime_algorithm=0, me_max_steps=-1, stats_audit=False,
                  rc_algorithm="lambda", cqmfile=None, sao_type=3,
                  deblock_enable=True, deblock_beta=0, deblock_tc=0,
                  rdoq_enable=False, signhide_enable=True, wpp=False,
                  ref_frames=1)
    couts = encode(Encoder(ccfg, device=dev), FramePlanes, clip[:3])
    same_bytes("9c CLI output", stream, b"".join(o[0] for o in couts))
    decoded = decode_stream(stream)
    if len(decoded) != 3 or not all(fr.checksum_ok for fr in decoded):
        fail(f"9c CLI output: {len(decoded)} frames decoded, checksums "
             f"{[fr.checksum_ok for fr in decoded]}")
    summary = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    print(f"phase 9c CLI: 3 frames {W}x{H} QP{QP} on the card in "
          f"{cwall:.3f} s (the subprocess, start-up included), "
          f"{len(stream)} bytes equal the Encoder's and decode through the "
          f"oracle; " + " | ".join(summary), flush=True)

    # 9d: the entry points
    fn_c, args_c = graft_entry.entry()
    fn_p, args_p = graft_entry.entry(device="cpu")
    best_c, cost_c = fn_c(*args_c)
    best_p, cost_p = fn_p(*args_p)
    same("rd_cost", "entry() best", best_c.cpu(), best_p)
    same("rd_cost", "entry() costs", cost_c.cpu(), cost_p)
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(8, device=dev)
    print(f"phase 9d entry points: entry() equals its plain form "
          f"({best_c.numel()} blocks), dryrun_multichip(8, device=cuda) on "
          "the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    print(f"phase 9 mesh, CLI and entry points: {checks - n0} comparisons, "
          "all equal", flush=True)

    # --- 10. small clips through the oracle decoder -------------------------
    stamp("10")
    for label, mk in (("all-intra", bench_config), ("low-delay", ld_config),
                      ("rdoq LD", rdoq_ld_config),
                      ("dense RA", dense_config), ("MIP", mip_config),
                      ("MTS", mts_config), ("10-bit LD", ld10_config),
                      ("slow RA", slow_ra_config), ("rough", rough_config)):
        scfg = mk(Config, 192, 128)
        senc = Encoder(scfg, device=dev)
        sout = encode(senc, FramePlanes,
                      clip_for(scfg, synth_clip(192, 128, 5)))
        dpb = {}
        for au, rec, fs, _rl, _src in sout:
            pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
            pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
            if fs.slicetype == SliceType.I:
                dpb.clear()
            orl = RefLists(l0=[dpb[q] for q in pocs0],
                           l1=[dpb[q] for q in pocs1], pocs0=pocs0,
                           pocs1=pocs1)
            dec, info = decode_au(au, scfg, senc.ctrl, fs, refs=orl)
            if not info["headers_ok"] or info["checksum_ok"] is not True:
                fail(f"oracle {label} poc {fs.poc}: headers_ok "
                     f"{info['headers_ok']}, checksum_ok {info['checksum_ok']}")
            for p in ("y", "u", "v"):
                if not np.array_equal(getattr(dec, p), getattr(rec, p)):
                    fail(f"oracle {label} poc {fs.poc}: decoded {p} differs "
                         "from the encoder's recon")
            dpb[fs.poc] = dec
        print(f"phase 10 oracle {label}: {len(sout)} frames 192x128 ("
              + "".join(SLICE[o[2].slicetype] for o in sout)
              + ") decode to the encoder's recon", flush=True)

    # --- 4d. the batched transforms and quantisers --------------------------
    # (run here, after phase 10: only this phase launches K13 and K14, whose
    # sources build in a process of their own from phase 2 on)
    stamp("4d")
    t_late = time.perf_counter()
    log, _ = late.communicate()
    if late.returncode != 0:
        fail(f"the build of {', '.join(LATE_SOURCES)} failed:\n{log}")
    kernels.build(LATE_SOURCES)            # built: only checks the cache
    print(f"phase 4d build of {', '.join(LATE_SOURCES)}: done "
          f"{time.perf_counter() - t_build:.3f} s after phase 2 began, waited "
          f"{time.perf_counter() - t_late:.3f} s", flush=True)
    ptxas(LATE_SOURCES)
    n0 = checks

    def tiles(plane, w, h):
        """The w x h blocks of a plane, cropped to whole blocks."""
        hh, ww = H // h * h, W // w * w
        return plane[:hh, :ww].reshape(hh // h, h, ww // w, w) \
            .transpose(1, 2).reshape(-1, h, w).contiguous()

    def tr_inputs(w, h, bd):
        """The frame's residuals (the clip scaled to the bit depth, minus
        1 << (bd - 1)), random residuals, int16-range inputs, and the int32
        extremes (random int32, a checkerboard of INT32_MAX and INT32_MIN:
        the butterflies' sums wrap there)."""
        res = tiles(frame_src, w, h) * (1 << (bd - 8)) - (1 << (bd - 1))
        mx = (1 << bd) - 1
        return {"frame": res,
                "rand": torch.randint(-mx, mx + 1, res.shape, generator=gen,
                                      device=dev, dtype=torch.int32),
                "int16": torch.randint(-32767, 32768, res.shape,
                                       generator=gen, device=dev,
                                       dtype=torch.int32),
                "int32": int32_extremes(res.shape)}

    def int32_extremes(shape):
        """Random int32 blocks, and every fourth a checkerboard of
        INT32_MAX and INT32_MIN."""
        x = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                          device=dev, dtype=torch.int64)
        h, w = shape[-2:]
        board = (torch.arange(h, device=dev)[:, None]
                 + torch.arange(w, device=dev)[None]) % 2 == 0
        x[::4] = torch.where(board, 2 ** 31 - 1, -2 ** 31)
        return x.to(torch.int32)

    def at_offset(t, o):
        """A copy of t that starts o elements past a 16-byte boundary."""
        flat = torch.empty(t.numel() + o, dtype=t.dtype, device=dev)
        view = flat[o:].view(t.shape)
        view.copy_(t)
        return view

    edges = torch.tensor([0, 1, -1, 200000, -200000, 2 ** 31 - 1, -2 ** 31,
                          32767, -32768, 26215, -26215, 29127],
                         dtype=torch.int32, device=dev)
    dct2_cls = [(w, h) for (w, h, _g) in classes]
    tr_shapes = [(w, h, DCT2, DCT2) for (w, h) in dct2_cls + [(32, 8),
                                                              (8, 32)]]
    tr_shapes += [(w, h, th, tv) for (w, h) in dct2_cls + [(32, 8), (8, 32)]
                  if max(w, h) <= 32
                  for th in (DST7, DCT8) for tv in (DST7, DCT8)]
    for (w, h, th, tv) in tr_shapes:
        for bd in (8, 10):
            for tag, x in tr_inputs(w, h, bd).items():
                what = f"{w}x{h} {th}/{tv} {bd}-bit {tag}"
                c = tr.fwd_batch(x, th, tv, bd)
                same("fwd_transform", what, c,
                     tr.fwd_batch_plain(x, th, tv, bd))
                cc = torch.cat([c.to(torch.int32), x])
                same("inv_transform", what, tr.inv_batch(cc, th, tv, bd),
                     tr.inv_batch_plain(cc, th, tv, bd))
                if th != DCT2 or tv != DCT2:
                    continue
                # the quantisers on the coefficients, int16-range values
                # and the int32 edges; on K13's int16 coefficients as they
                # are, and both at an element offset of 1, 2 and 4
                lv = cc.clone()
                lv[0].view(-1)[:min(edges.numel(), w * h)] = \
                    edges[:w * h]
                levels = {"int32": lv, "int16": c}
                if tag == "frame":
                    levels.update({f"{k} +{o}": at_offset(v, o)
                                   for k, v in (("int32", lv), ("int16", c))
                                   for o in (1, 2, 4)})
                for qp in TR_QPS + (51 if bd == 8 else 63,):
                    for lk, lx in levels.items():
                        for intra in (True, False):
                            same("quant_levels",
                                 f"{what} {lk} qp{qp} {intra}",
                                 qu.quant_batch(lx, qp, bd, intra),
                                 qu.quant_batch_plain(lx, qp, bd, intra))
                        same("dequant_levels", f"{what} {lk} qp{qp}",
                             qu.dequant_batch(lx, qp, bd),
                             qu.dequant_batch_plain(lx, qp, bd))
    # K13 at every lattice shape (its templates) and at the generic shapes
    # (a dimension of 1 or 2, 10 bits), one block more than a thread block
    # holds, on residuals and the int32 extremes; K14 on element counts that
    # are not multiples of 8 (2x1 and 1x1 blocks at 10 bits, int16 and
    # int32, at an offset too)
    sizes = (4, 8, 16, 32, 64)
    for (w, h) in ([(w, h) for w in sizes for h in sizes]
                   + [(1, 8), (8, 1), (2, 4), (2, 64), (64, 2), (1, 1)]):
        bds = (10,) if min(w, h) < 4 else (8, 10)
        nblk = max(1, 2048 // (w * h)) + 1
        for bd in bds:
            mx = (1 << bd) - 1
            x = torch.cat([torch.randint(-mx, mx + 1, (nblk, h, w),
                                         generator=gen, device=dev,
                                         dtype=torch.int32),
                           int32_extremes((4, h, w))])
            what = f"{w}x{h} {bd}-bit lattice"
            c = tr.fwd_batch(x, DCT2, DCT2, bd)
            same("fwd_transform", what, c, tr.fwd_batch_plain(x, DCT2,
                                                               DCT2, bd))
            cc = torch.cat([c.to(torch.int32), x])
            same("inv_transform", what, tr.inv_batch(cc, DCT2, DCT2, bd),
                 tr.inv_batch_plain(cc, DCT2, DCT2, bd))
    odd = torch.cat([edges, torch.randint(-40000, 40000, (2 * 37,),
                                          generator=gen, device=dev,
                                          dtype=torch.int32)])
    for shape in ((43, 2, 1), (86, 1, 1)):
        for lk, lx in (("int32", odd.view(shape)),
                       ("int16", odd.to(torch.int16).view(shape)),
                       ("int32 +1", at_offset(odd.view(shape), 1)),
                       ("int16 +1", at_offset(odd.to(torch.int16).view(shape),
                                              1))):
            for qp in TR_QPS + (63,):
                what = f"{shape[2]}x{shape[1]} 10-bit {lk} qp{qp}"
                same("quant_levels", what, qu.quant_batch(lx, qp, 10),
                     qu.quant_batch_plain(lx, qp, 10))
                same("dequant_levels", what, qu.dequant_batch(lx, qp, 10),
                     qu.dequant_batch_plain(lx, qp, 10))
    # the wrap edges of the reference: 8x4 at 10 bits, qp_scaled 63, levels
    # of magnitude 26215 and more (level * (80 << 10) passes 2^31), and the
    # quant of 200000 at 4x4 10 bits, qp_scaled 0
    big = torch.randint(26215, 32768, (1024, 4, 8), generator=gen,
                        device=dev, dtype=torch.int32)
    big[1::2] = -big[1::2]
    big[0, 0, :2] = torch.tensor([29127, -32768], dtype=torch.int32)
    dq = qu.dequant_batch(big, 63, 10)
    same("dequant_levels", "8x4 10-bit qp63 wrap", dq,
         qu.dequant_batch_plain(big, 63, 10))
    if dq[0, 0, :2].tolist() != [-32768, 32767]:
        fail(f"dequant_levels: 29127 and -32768 at 8x4 10-bit qp63 gave "
             f"{dq[0, 0, :2].tolist()}, the reference's wrap gives "
             "[-32768, 32767]")
    q200 = qu.quant_batch(torch.full((64, 4, 4), 200000, dtype=torch.int32,
                                     device=dev), 0, 10)
    if not bool((q200 == 7231).all()):
        fail("quant_levels: 200000 at 4x4 10-bit qp0 is not the reference's "
             "7231")
    # times at the frame's residuals (8 bits, QP22), once per class; the
    # float64 matmul chain as K13's library time, equal on these inputs
    for (w, h) in dct2_cls:
        x = tr_inputs(w, h, 8)["frame"]
        s1, s2 = tr.fwd_shifts(w, h, 8)
        i1, i2 = tr.inv_shifts(8)
        keep_w, keep_h = tr.zero_out(w, DCT2, DCT2, h)
        mw = device_matrix(DCT2, w, str(dev)).double()
        mh = device_matrix(DCT2, h, str(dev)).double()
        c = tr.fwd_batch(x, DCT2, DCT2, 8)
        lv = qu.quant_batch(c, QP, 8)
        dq = qu.dequant_batch(lv, QP, 8)
        same("fwd_transform", f"{w}x{h} float64 chain", c,
             fwd_f64(torch, x, mw, mh, s1, s2, keep_w, keep_h))
        same("inv_transform", f"{w}x{h} float64 chain",
             tr.inv_batch(dq, DCT2, DCT2, 8),
             inv_f64(torch, dq, mw, mh, i1, i2))
        shape = dict(B=x.shape[0], w=w, h=h, H_=H, W_=W)
        for name, kern, plain, lib in (
                ("fwd_transform", lambda: tr.fwd_batch(x, DCT2, DCT2, 8),
                 lambda: tr.fwd_batch_plain(x, DCT2, DCT2, 8),
                 lambda: fwd_f64(torch, x, mw, mh, s1, s2, keep_w, keep_h)),
                ("inv_transform", lambda: tr.inv_batch(dq, DCT2, DCT2, 8),
                 lambda: tr.inv_batch_plain(dq, DCT2, DCT2, 8),
                 lambda: inv_f64(torch, dq, mw, mh, i1, i2)),
                ("quant_levels", lambda: qu.quant_batch(c, QP, 8),
                 lambda: qu.quant_batch_plain(c, QP, 8), None),
                ("dequant_levels", lambda: qu.dequant_batch(lv, QP, 8),
                 lambda: qu.dequant_batch_plain(lv, QP, 8), None)):
            timed(name, kern, plain, f"{w}x{h}", **shape,
                  **({"in_bytes": 2} if name == "quant_levels" else {}))
            if lib is not None:
                lib_ms = time_ms(torch, lib, 20)
                library_ms[name] = (library_ms[name] or 0.0) + lib_ms
                print(f"  {name} {w}x{h}: {lib_ms:.4f} ms float64 "
                      "torch.matmul chain", flush=True)
    print(f"phase 4d transform and quant kernels: {checks - n0} comparisons, "
          "all equal", flush=True)

    # the slice's own path: the frame's residuals through the four batched
    # entry points per class, the output held against the numpy host
    # functions (no int32 edge on these inputs) on sampled blocks
    resid = {(w, h): tr_inputs(w, h, 8)["frame"] for (w, h) in dct2_cls}

    def round_trip():
        return {k: tr.inv_batch(qu.dequant_batch(qu.quant_batch(
            tr.fwd_batch(x), QP), QP)) for k, x in resid.items()}

    kernels.reset_launches()
    recon = round_trip()
    torch.cuda.synchronize()
    expect("transform round trip", dict(kernels.LAUNCHES),
           dict.fromkeys(TR_KERNELS, len(dct2_cls)))
    for (w, h), r in recon.items():
        xs_np, r_np = resid[(w, h)].cpu().numpy(), r.cpu().numpy()
        for b in np.linspace(0, len(xs_np) - 1, 8).astype(int):
            c_np = tr.fwd_transform_2d(xs_np[b])
            want = tr.inv_transform_2d(qu.dequant(
                qu.quant(c_np.astype(np.int32), QP).astype(np.int32), QP)
                .astype(np.int32))
            if r_np[b].dtype != np.int16 or not np.array_equal(r_np[b], want):
                fail(f"transform round trip {w}x{h} block {b}: differs from "
                     "the numpy host functions")
    print("phase 4d transform round trip: launches "
          + json.dumps({k: counts["transform round trip"][k]
                        for k in TR_KERNELS})
          + ", sampled blocks equal the numpy host functions", flush=True)
    print(busy_share(torch, round_trip), flush=True)

    # --- 11. the presets and the host tools ---------------------------------
    stamp("11")
    cpu_ref = cpu_half(cpu11, 11)

    def fused_counts(n_cls, types, k8=0):
        """Launches of a path whose frames (slice types ``types``) all take
        the fused search over n_cls classes: K1-K4 once per class and frame
        (the I frames' search, the P/B frames' intra screen), K5 once per
        P/B frame, K8 once per P/B frame with inter leaves (k8)."""
        n_p = sum(1 for t in types if t != "I")
        return {**dict.fromkeys(INTRA_KERNELS, n_cls * len(types)),
                "pseudo_recon": n_p, "leaf_qpel": k8}

    def phase11_run(label, pcfg, n, profiled=False):
        """One phase-11 encode on the card with its launch checks, held
        against the CPU half's frames -> (encoder, outputs, wall s, launches,
        clip, card-vs-CPU summary, the profiler's line or None). profiled:
        the encode runs under the profiler, its wall included."""
        pclip = [FramePlanes(*f) for f in job_clip(pcfg, n)]
        got = {}

        def run():
            got["run"] = counting_k8(lambda: timed_encode(pcfg, pclip))
        busy = busy_share(torch, run) if profiled else run()
        (penc, pouts, pwall, launches), k8 = got["run"]
        native(label, penc)
        if len(pouts) != n:
            fail(f"{label} returned {len(pouts)} of {n} frames")
        for au, rec, _fs, _refs, _src in pouts:
            if not au or rec.y.shape != (pcfg.height, pcfg.width):
                fail(f"{label} produced an empty AU or a malformed recon")
        if pcfg.mts in (1, 3) or not getattr(penc.slice_enc,
                                             "_fused_entries_c", None):
            # MTS, or a class with no position (the fused search declines):
            # search_blocks / dispatch_blocks and search_combined per class
            want = combined_counts(penc, pouts, pcfg)
        else:
            want = fused_counts(n_classes(penc), "".join(
                SLICE[o[2].slicetype] for o in pouts), k8)
        expect(label, launches, want)
        msg = card_vs_cpu(label, pouts, n, cpu_ref[label])
        return penc, pouts, pwall, launches, pclip, msg, busy

    # 11a: every preset at 832x480; slower..placebo (40-50 s an encode on
    # an H100 80GB HBM3 at 700 W) run once, under the profiler (there its
    # wall came within 4% of an unprofiled encode's), the others twice
    for preset in PRESETS:
        slow = preset in SLOW_PRESETS
        n = SLOW_PRESET_FRAMES if slow else PRESET_FRAMES
        pcfg = make_config(preset, width=W, height=H)
        penc, pouts, pwall, launches, pclip, msg, busy = phase11_run(
            f"preset {preset}", pcfg, n, profiled=slow)
        print(f"phase 11a preset {preset}: {n} frames {W}x{H} QP{pcfg.qp} "
              f"({''.join(SLICE[o[2].slicetype] for o in pouts)}) in "
              f"{pwall:.3f} s = {n / pwall:.3f} fps wall"
              + (" (profiled)" if slow else "") + ", "
              f"{sum(len(o[0]) for o in pouts)} bytes, card = CPU ({msg}), "
              "launches " + json.dumps(
                  {k: v for k, v in launches.items() if v}), flush=True)
        print(busy or busy_share(torch, lambda: encode(
            Encoder(pcfg, device=dev), FramePlanes, pclip)), flush=True)

    # 11b: the host tools at 136x72 (the plane pads to 144x80)
    msg = []
    for tool, opts in HOST_TOOLS.items():
        pcfg = Config(width=TOOL_W, height=TOOL_H, **opts)
        penc, pouts, pwall, launches, _c, m, _b = phase11_run(
            f"host tool {tool}", pcfg, TOOL_CLIP)
        msg.append(f"{tool} ({''.join(SLICE[o[2].slicetype] for o in pouts)}"
                   f", {sum(len(o[0]) for o in pouts)} B, K1-K4 "
                   f"{launches['predict67']}, K5 {launches['pseudo_recon']}"
                   f", K8 {launches['leaf_qpel']})")
    print(f"phase 11b host tools at {TOOL_W}x{TOOL_H}, {TOOL_CLIP} frames "
          "each, card = CPU: " + "; ".join(msg), flush=True)

    # 11c: under 64 samples the 64x64 class has no position and is skipped
    # (every wrapper refuses an empty batch)
    pcfg = Config(width=SMALL_W, height=SMALL_H)
    penc, pouts, pwall, launches, _c, m, _b = phase11_run(
        f"LD {SMALL_W}x{SMALL_H}", pcfg, 3)
    print(f"phase 11c LD {SMALL_W}x{SMALL_H} (Config defaults): card = CPU "
          f"({m}), launches " + json.dumps(
              {k: v for k, v in launches.items() if v}), flush=True)

    # --- 12. the reference's 1080p configurations and a 2160p batch --------
    stamp("12")
    t12 = time.perf_counter()
    from uvg266_tpu_torch.tools.bdrate import CONFIGS
    from uvg266_tpu_torch.tools.bdrate import synth_clip as bd_clip
    from uvg266_tpu_torch.tools.bdrate import write_yuv
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CTC_FIXTURE)) as fh:
        fixture = json.load(fh)["encodes"]
    for label, (_c, _q, n, _e, _w, _h) in CTC.items():
        if len(fixture.get(label, {}).get("port", ())) != n:
            fail(f"phase 12: {CTC_FIXTURE} has no {n} frames of {label}")

    # K1-K4 at the 2160p batch's 64x64 and 8x8 classes (three 10-bit
    # frames: K2's output is 77.6% of 2^31 elements) against their plain
    # versions on the card, tolerance 0; the large outputs compared in
    # pieces of 2^26 elements
    n0 = checks
    ucfg = ctc_config("2160p ai10 q22")
    uctrl = EncoderControl(ucfg)
    uent = SliceEncoder(ucfg, uctrl, device=dev)._fused_entries(
        PartitionSearch(uctrl, ucfg, qp=ucfg.qp))
    usrc = torch.from_numpy(np.stack(
        [f[0] for f in ctc_clip(ucfg.width, ucfg.height, 3, 10)])).to(dev)
    uft = frame_tables(ucfg.qp, "cuda")

    def same_big(name, what, a, b):
        a, b = a.reshape(-1), b.reshape(-1)
        if a.shape != b.shape:
            fail(f"{name} {what}: {a.shape} vs {b.shape}")
        for i in range(0, a.numel(), 1 << 26):
            same(name, f"{what} [{i}:]", a[i:i + (1 << 26)],
                 b[i:i + (1 << 26)])
    for (_k, w, h, _p, g) in uent:
        if w not in (64, 8):
            continue
        what = f"2160p F=3 {w}x{h} B={3 * g[4] * g[5]}"
        tabs = device_tables(w, h, 10, "cuda")
        refs, blocks = ib.refs_blocks_grid(usrc, w, h, g)
        for o, a, b in zip(("refs", "blocks"), (refs, blocks),
                           ib.refs_blocks_grid_plain(usrc, w, h, g)):
            same_big("refs_blocks_grid", f"{what} {o}", a, b)
        preds = ib.predict67(refs, tabs)
        same_big("predict67", what, preds, ib.predict67_plain(refs, tabs))
        satds = ib.satd67(preds, blocks)
        same("satd67", what, satds, ib.satd67_plain(preds, blocks))
        args = (preds, blocks, satds, uctrl.luma_qp_scaled(ucfg.qp),
                float(np.float32(qp_to_lambda(ucfg.qp))), uft["wts"],
                uft["mode_bits"], tabs, 10)
        for o, a, b in zip(("best", "rd", "satd"), rc.rd_cost(*args),
                           rc.rd_cost_plain(*args)):
            same("rd_cost", f"{what} {o}", a, b)
        del refs, blocks, preds, satds, args
    del usrc
    torch.cuda.empty_cache()
    print(f"phase 12 K1-K4 at the 2160p batch's 64x64 and 8x8 classes: "
          f"{checks - n0} comparisons, all equal", flush=True)

    # the wrappers of K1-K6, K8, K9a and K9b record their calls on the
    # encodes that time them at 1080p (TIMED_AT), and the largest element
    # offset of every tensor they pass or get on the 2160p batch. K3's and
    # K4's calls keep no predictions (560 MB a class and frame): the timing
    # makes each class's again from K2's call of the same class
    wrapped = {"refs_blocks_grid": ib, "predict67": ib, "satd67": ib,
               "rd_cost": rc, "pseudo_recon": pr, "rd_cost_pred": rc,
               "leaf_qpel": mf, "fullpel_search": me, "frac_search": me}
    plain_fn = {k: getattr(m, k) for k, m in wrapped.items()}
    rec12 = {"mode": None, "names": (), "calls": [], "largest": {}}

    def recording(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            if rec12["mode"] == "calls" and name in rec12["names"]:
                if name in ("satd67", "rd_cost"):
                    a = (None, *a[1:])
                rec12["calls"].append((name, a, k))
            elif rec12["mode"] == "largest":
                ts = [t for t in (*a, *k.values(),
                                  *(out if isinstance(out, tuple) else (out,)))
                      if isinstance(t, torch.Tensor)]
                rec12["largest"][name] = max(rec12["largest"].get(name, 0),
                                             max(t.numel() for t in ts) - 1)
            return out
        return call
    for name, mod in wrapped.items():
        setattr(mod, name, recording(name, plain_fn[name]))
    # the kernels each encode's calls time (device ms a frame at 1080p)
    TIMED_AT = {"1080p allintra q22": INTRA_KERNELS,
                "1080p lowdelay q22": ("pseudo_recon",),
                "1080p default q27": ("leaf_qpel",),
                "1080p ld10 q27": ("fullpel_search", "frac_search",
                                   "rd_cost_pred")}
    at1080 = {}

    def call_work(name, a, k):
        """(bytes, operations) of one recorded call (work())."""
        if name == "refs_blocks_grid":
            s_, w_, h_, g_ = a[:4]
            F_ = s_.shape[0] if s_.dim() == 3 else 1
            return work(name, F_ * g_[4] * g_[5], w_, h_,
                        F_ * s_.shape[-2], s_.shape[-1])
        if name == "predict67":
            modes = a[2] if len(a) > 2 else k.get("modes")
            return work(name, a[0].shape[0], a[1]["w"], a[1]["h"], 0, 0,
                        M=67 if modes is None else modes.shape[0])
        if name in ("satd67", "rd_cost"):
            B_, M_, h_, w_ = a[0].shape
            return work(name, B_, w_, h_, 0, 0, M=M_)
        if name == "pseudo_recon":
            return work(name, 0, 16, 16, *a[0].shape)
        if name == "rd_cost_pred":
            B_, h_, w_ = a[0].shape
            return work(name, B_, w_, h_, 0, 0)
        if name == "leaf_qpel":
            return work(name, 0, 8, 8, 0, 0, nt=a[0].shape[0], nl=a[3])
        B_, h_, w_ = a[1].shape
        if name == "fullpel_search":
            return work(name, B_, w_, h_, *a[0].shape, r=a[4])
        return work(name, B_, w_, h_, *a[0].shape,
                    winner=bool(a[8] if len(a) > 8
                                else k.get("winner_only", False)))

    def time_calls(label, n_frames):
        """Each recorded call replayed 10 times from a CUDA graph: device ms,
        launches and bound a frame of encode ``label``, by kernel."""
        per, k2_calls, preds = {}, [], {}
        for name, a, k in rec12["calls"]:
            fn = plain_fn[name]
            if name == "predict67":
                k2_calls.append((a, k))
            elif a[0] is None:
                # the predictions of K2's call of the same class
                i = per.get(name, [0, 0])[1]
                if i not in preds:
                    preds.clear()
                    pa, pk = k2_calls[i]
                    preds[i] = plain_fn["predict67"](*pa, **pk)
                a = (preds[i], *a[1:])
            g_ms = graph_ms(torch, lambda: fn(*a, **k), 10)
            b, o = call_work(name, a, k)
            row = per.setdefault(name, [0.0, 0, 0, 0])
            row[0] += g_ms
            row[1] += 1
            row[2] += b
            row[3] += o
        for name, (g_ms, n, b, o) in per.items():
            tb, to = b / HBM_BYTES_PER_S, o / OPS_PER_S
            at1080[name] = {
                "path": label, "device_ms": g_ms / n_frames,
                "launches": n / n_frames,
                "bound_ms": max(tb, to) * 1e3 / n_frames,
                "bound_by": "bytes" if tb >= to else "operations"}
        rec12["calls"] = []
        preds.clear()

    def same_as_fixture(label, got, keys=("type", "au", "au_bytes", "recon",
                                          "rec_out")):
        want = fixture[label]["port"][:len(got)]
        for i, (a, b) in enumerate(zip(got, want)):
            for key in keys:
                if a[key] != b[key]:
                    fail(f"phase 12 {label} frame {i}: {key} {a[key]} "
                         f"differs from the fixture's {b[key]}")

    # a warm-up frame at 1920x1080 (the first call of each new shape)
    first = next(iter(CTC))
    encode(Encoder(ctc_config(first), device=dev), FramePlanes,
           ctc_clip(*CTC[first][4:], 1))
    n_cls_ld = None
    for label, (conf, qp12, n12, entry, w12, h12) in CTC.items():
        cfg12 = ctc_config(label)
        bd12 = cfg12.input_bitdepth
        frames12 = ctc_clip(w12, h12, n12, bd12)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if entry == "cli":
            # the CLI as tools/bdrate.py run_ours runs it, in a subprocess
            # that reports the launches its kernels made
            with tempfile.TemporaryDirectory() as td:
                yuv = os.path.join(td, "clip.yuv")
                write_yuv(bd_clip(w12, h12, n12, seed=7), yuv)
                out_f, rec_f = (os.path.join(td, "out.vvc"),
                                os.path.join(td, "rec.yuv"))
                argv = ["-i", yuv, "--input-res", f"{w12}x{h12}", "-q",
                        str(qp12), "-n", str(n12), "-o", out_f, "--device",
                        "cuda", "--rec-out", rec_f, *CONFIGS[conf][1]]
                t0 = time.perf_counter()
                r = subprocess.run([sys.executable, "-c", CLI_WITH_LAUNCHES,
                                    *argv], capture_output=True, text=True,
                                   timeout=600,
                                   cwd=os.path.dirname(
                                       os.path.abspath(__file__)))
                wall12 = time.perf_counter() - t0
                if r.returncode != 0:
                    fail(f"phase 12 {label}: the CLI failed: "
                         f"{r.stderr[-2000:]}")
                with open(out_f, "rb") as fh:
                    stream = fh.read()
                with open(rec_f, "rb") as fh:
                    rec_bytes = fh.read()
            launches = json.loads(r.stdout.split("LAUNCHES ")[-1])
            sizes = [f["au_bytes"] for f in fixture[label]["port"]]
            if len(stream) != sum(sizes):
                fail(f"phase 12 {label}: {len(stream)} bytes written, the "
                     f"fixture's AUs hold {sum(sizes)}")
            fsize = w12 * h12 * 3 // 2
            got12, off = [], 0
            for i, sz in enumerate(sizes):
                got12.append({
                    "au": hashlib.sha256(stream[off:off + sz]).hexdigest(),
                    "rec_out": hashlib.sha256(
                        rec_bytes[i * fsize:(i + 1) * fsize]).hexdigest()})
                off += sz
            same_as_fixture(label, got12, ("au", "rec_out"))
            types = "".join(f["type"] for f in fixture[label]["port"])
            expect(label, launches, fused_counts(n_cls_ld, types))
            summary = [ln.strip() for ln in r.stdout.splitlines()
                       if "Processed" in ln or "Total time" in ln]
            print(f"phase 12 {label}: the CLI ({' '.join(CONFIGS[conf][1])})"
                  f" in a subprocess, {n12} frames {w12}x{h12} ({types}) in "
                  f"{wall12:.3f} s = {n12 / wall12:.3f} fps (subprocess wall, "
                  f"start-up included), {len(stream)} bytes and its --rec-out"
                  " equal the fixture, launches " + json.dumps(
                      {k: v for k, v in launches.items() if v}) + "; "
                  + " | ".join(summary), flush=True)
            continue
        timed_by = TIMED_AT.get(label, ())
        rec12["mode"] = ("largest" if entry == "batch"
                         else "calls" if timed_by else None)
        rec12["names"] = timed_by
        got = {}

        def run12():
            if entry == "batch":
                t0 = time.perf_counter()
                outs = ctc_encode(port_api(dev), cfg12, frames12, entry)
                torch.cuda.synchronize()
                return outs, time.perf_counter() - t0, dict(kernels.LAUNCHES)
            return counting_k8(lambda: timed_encode(
                cfg12, [FramePlanes(*f) for f in frames12]))
        kernels.reset_launches()
        busy = busy_share(torch, lambda: got.setdefault("r", run12()),
                          every=True)
        peak = torch.cuda.max_memory_allocated()
        rec12["mode"] = None
        if entry == "batch":
            outs12, wall12, launches = got["r"]
            n_cls = len(search_classes(PartitionSearch(
                EncoderControl(cfg12), cfg12, qp=qp12)))
            want = dict.fromkeys(INTRA_KERNELS, n_cls)
            types = "I" * n12
        else:
            (penc, pouts, wall12, launches), k8 = got["r"]
            native(label, penc)
            outs12 = [(o[0], o[1], int(o[2].slicetype)) for o in pouts]
            types = "".join(SLICE[t] for _a, _r, t in outs12)
            if conf == "ld10":
                want = combined_counts(penc, pouts, cfg12)
                if not want.get("fullpel_search"):
                    fail(f"{label}: no inter class searched")
            else:
                want = fused_counts(n_classes(penc), types, k8)
                if conf == "lowdelay":
                    n_cls_ld = n_classes(penc)
                if conf == "default" and k8 == 0:
                    fail(f"{label}: no inter leaf refined")
        if len(outs12) != n12:
            fail(f"phase 12 {label} returned {len(outs12)} of {n12} frames")
        expect(label, launches, want)
        same_as_fixture(label, frame_digests(outs12, cfg12))
        print(f"phase 12 {label}: {entry} entry, {n12} frames {w12}x{h12} "
              f"{bd12}-bit QP{qp12} ({types}) in {wall12:.3f} s = "
              f"{n12 / wall12:.3f} fps wall (profiled), "
              f"{sum(len(o[0]) for o in outs12)} bytes, every frame's AU and "
              f"recon equal the fixture, peak device memory {peak} B "
              f"(max_memory_allocated), launches " + json.dumps(
                  {k: v for k, v in launches.items() if v}), flush=True)
        print(busy, flush=True)
        if entry == "batch":
            print(f"phase 12 {label}: largest element offset each wrapper's "
                  "tensors reach, against 2^31 = 2147483648: " + ", ".join(
                      f"{k} {v} ({v / 2 ** 31:.3f})"
                      for k, v in rec12["largest"].items()), flush=True)
            if max(rec12["largest"].values()) >= 2 ** 31:
                fail(f"phase 12 {label}: an element offset reaches 2^31")
        if timed_by:
            time_calls(label, n12)
        got.clear()
        del outs12
    for name, mod in wrapped.items():
        setattr(mod, name, plain_fn[name])
    for name in ("refs_blocks_grid", "predict67", "satd67", "rd_cost",
                 "pseudo_recon", "rd_cost_pred", "leaf_qpel",
                 "fullpel_search", "frac_search"):
        a = at1080.get(name)
        if a is None:
            fail(f"phase 12: {name} was not timed at 1080p")
        print(f"phase 12 {name} at 1920x1080 ({a['path']}): device "
              f"{a['device_ms']:.4f} ms a frame on the graph, "
              f"{a['launches']:.2f} launches a frame, bound "
              f"{a['bound_ms']:.4f} ms ({a['bound_by']})"
              + ("" if name not in INTRA_KERNELS + ("pseudo_recon",) else
                 f"; {a['device_ms'] / dev_ms[name]:.2f}x this run's 832x480"
                 f" graph time {dev_ms[name]:.4f} ms a frame"), flush=True)

    # the children's phase-12 encodes against the fixture
    ctc_ref = cpu_half(ctc_half, 12)
    pool.close()
    pool.join()
    for label, n in CTC_CPU:
        same_as_fixture(label, ctc_ref[label])
    print(f"phase 12 CPU half: {', '.join(f'{k} ({n} frames)' for k, n in CTC_CPU)}"
          f" equal the fixture on every frame; phase 12 took "
          f"{time.perf_counter() - t12:.3f} s", flush=True)

    # --- 14. the meshes over several cards --------------------------------
    stamp("14")
    got14, n14 = mesh_cards(torch, kernels)
    checks += n14
    mesh_counts.update(got14)

    # --- 13. results --------------------------------------------------------
    stamp("13")
    rows = []
    for name in REPLACES:
        t_bytes = bytes_[name] / HBM_BYTES_PER_S
        t_ops = ops[name] / OPS_PER_S
        rows.append({
            "name": name, "route": "cuda",
            "source": f"uvg266_tpu_torch/csrc/{kernels.source_of(name)}.cu",
            "replaces": REPLACES[name],
            "launches": counts[MAIN_PATH[name]][name],
            "max_abs_err": err[name],
            "ms": ms[name], "device_ms": dev_ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms[name],
            "path": MAIN_PATH[name] + (" (no encode path reaches it)"
                                       if name in TR_KERNELS else ""),
            "mesh_launches": {p: c.get(name, 0)
                              for p, c in mesh_counts.items()},
        })
        if name == "frac_search":
            # the row is the winner form's (the one the path launches)
            rows[-1]["contract_form"] = dict(frac_contract)
        if name == "rough_refine":
            # the row is the chain's; its two selection stages alone
            rows[-1]["stages"] = k12c_stages
        if name in at1080:
            # device ms, launches and bound a frame of a phase-12 encode
            rows[-1]["at_1920x1080"] = at1080[name]
    print(f"phase 13 results: the smoke took {time.perf_counter() - t_start:.3f}"
          " s from phase 1; seconds by phase: " + ", ".join(
              f"{a} {t1 - t0:.1f}" for (a, t0), (_b, t1) in zip(
                  stamps, stamps[1:])), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(mesh_cards_main() if sys.argv[1:] == ["--mesh-cards"]
             else main())
