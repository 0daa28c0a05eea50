#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``moshi_tpu_torch``) on one card.

    python3 chip_smoke.py [--out F]

Phases, each fatal on failure (exit code 1, and the final result line is
never printed).  Eleven paths run: the full-duplex speech-to-speech frame
(STS: the 7B q4_k LM, kernels K1-K5) and the speech-to-text frame (STT:
the dense bf16 stt-1b-class LM of ``configs/bench/stt-1b-class.json``,
whose temporal stack takes the generic layer path and runs K9, which
replaces ``moshi_tpu/nn/pallas_attention.py:99`` with
``moshi_tpu_torch/csrc/decode_attention.cu``, and K11, which replaces
``moshi_tpu/nn/pallas_ring.py:99`` with ``moshi_tpu_torch/csrc/ring_write.cu``),
at B = 1; and the batched STS frame (``runtime/serving.py``
``SessionPool`` with POOL_B sessions), where every product takes the
dequant kernels: K2, K6 (``qmatmul_pallas``, the flat products) and K8
(``glu_matmul_pallas_stacked``, the GLUs), with K3 and K4; and two TTS
paths on the cross-attention TTS class (``tts_config``:
``configs/bench/tts-default-class.json`` with cross_attention on), whose
temporal stack takes the generic layer path: the B = 1 TTS frame
(``TTSPipeline.step_device`` with a synthetic voice: K1, K5, K2, K3, K9,
K11; path "tts"), and ``TTSSessionPool`` at POOL_B slots (path
"tts_pool"), whose temporal GLUs take K7 (``glu_matmul_pallas``, which
``moshi_tpu_torch/csrc/glu_matvec.cu`` replaces); and two megakernel
paths (``MOSHI_TPU_MEGAKERNEL``, set around their runs and restored, so
that every other path runs as it did): "sts_mega", the 7B STS frame under
``all``, whose temporal stack is one K13 launch
(``csrc/temporal_step.cu``, replacing ``pallas_temporal.py``
``temporal_full_step``) on the flat ring and whose depformer frame is one
K14c launch (``csrc/dep_step.cu``, replacing ``pallas_depformer.py``
``dep_frame_step``), with K1 for the text head and the depformer's input
projection; and "dep_mega", 2 layers of the 7B geometry at a card that is
not a multiple of 128 under ``dep``, whose depformer takes one K14a
launch per step (``dep_step.cu``'s ``dep_full_step``, which also stands
for ``dep_layer_step``); and two knob paths of the 7B frame at B = 1
(set around their runs and restored in the same way): "sts_mxu", the STS
frame under ``MOSHI_TPU_ATTN_MXU=1`` with ``MOSHI_TPU_KSEG=1``, whose
stacked decode attentions take K10 (``decode_attention.cu``'s third
instance, replacing ``pallas_attention.py``'s MXU form) and whose
temporal linear_out takes K12's k-segment form
(``csrc/split_matvec.cu``), and "lm_split", its LM frame under
``MOSHI_TPU_ATTN_MXU=1`` with ``MOSHI_TPU_SPLIT_SPREAD=1`` (K12's
split-spread form); and three paths on fp8 KV rings
(``LMConfig.kv_dtype = "float8_e4m3fn"``, phase 9, after every other
phase so that their readings stay as they were): "sts_fp8", the 7B STS
frame, whose temporal stack takes K3 and K4 in their fp8 forms (the
depformer's rings stay bf16); "pool_fp8", the B = POOL_B ``SessionPool``
on fp8 rings; and "stt_fp8", the STT frame, whose K9 and K11 take their
fp8 forms; and the last two kernel forms (phase 10, after phase 9):
"sts_i8", the 7B STS frame on weights in unpacked int8 storage
(``quant/formats.py`` ``i8_storage_tree``, the JAX package's
``bench.py --i8-storage``), whose K1 and K5 take their i8 forms (the
Pallas kernels' ``packed=False`` bodies), and "sts_mega_fp8", the 7B STS
frame under ``MOSHI_TPU_MEGAKERNEL=all`` on fp8 flat rings, whose K13
takes its fp8 form.  Three more paths launch the frames' kernels through
the offline scans and the streaming sessions (phase 7): "sts_scan" and
"stt_scan" (``STSPipeline`` / ``STTPipeline.scan_frames``: Mimi over the
clip a chunk at a time, the LM frame by frame) and "session"
(``runtime/session.py`` ``LMGenerator`` on the 7B).  ``_SOURCES`` names
every kernel's source and TPU
kernel.

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA kernel from ``moshi_tpu_torch/csrc`` (``nvcc``
   for sm_90a into ``build/moshi_tpu_torch``), with its wall time;
3. every kernel at the shapes its frame gives it, on the synthetic
   weights: the kernel against its plain PyTorch version on the same
   inputs on the card, over several input draws, with the largest error
   held under the kernel's limit (``TOL``) and a control (the plain
   version with one rounding changed, see ``TOL``) held above it; then
   the kernel's, the plain version's and one PyTorch library call's
   device times beside the least time the card could take (``bound_ms``:
   the larger of the bytes moved over 3.35 TB/s and the operations over
   the card's peak rate for their type).  K1-K5 at the 7B shapes; K9 at
   the stt-1b ring (B 1, H 16, hd 128, cap = context = 750) in three ring
   states (a fresh session, a partly filled ring, a wrapped one) and on a
   wrapped ring built so that K9's chunking decides a rounding, and K11
   (bit-exact) writing a layer's k and v rings in one launch from f32 rows
   at offsets past the ring; and the stt-1b's dense products in both forms
   (one cuBLAS call with bf16 operands and an f32 output, and both
   operands widened to f32), which must agree; then the ring writes on
   every case (``check_ring_writes``: K11's pair and one-ring entries and
   K4, bf16 and fp8 rings, f32 and bf16 rows, B = 1 and POOL_B, rows
   contiguous and strided, at ``ring_offsets`` (int32) and past 2^40
   (int64), every ring byte equal to the plain version's after every
   call); then the batched frame's
   kernels at B = POOL_B: every product on K2, K6 or K8 (K6 and K8 also at
   POOL_M_EXTRA rows), K3 with every session at another age, some on
   wrapped rings, and K4 writing all their slots; then K6 and K2 (layer 1
   of 2) on one-hot activation rows against weights whose blocks carry
   every finite bf16 scale (``check_dequant_probe``: each output is one
   dequantized element and must equal ``dequantize_layer_bf16``
   exactly); then, at the TTS class's shapes, K1 at TTS_ROWS rows (the
   rows MOSHI_TPU_INT8_MAX_M > 1 sends it), K7 at POOL_B and
   POOL_M_EXTRA rows with and without the fused norm, K9 over the
   500-slot ring with POOL_B session ages (some wrapped) and K11 (k and
   v in one launch, from strided f32 rows) into it,
   and K6, K2 and K8 at the TTS pool's products
   (``tts_pool_matvec_cases``, timed as the pool's); then the
   megakernels at the 7B's shapes: K13 over all 32 layers on a fresh
   ring and on a full 3000-slot ring,
   and over 2 layers on the full ring (where its attention's roundings
   are held: a 32-layer reading spreads over them), K14a at each
   depformer step 0-7 (q4_0 linear_out), K14c at temp 0 and at the
   pipeline's sampling defaults over DRAWS noise draws (each step's
   logits written out for the check, the decided tokens equal); no
   single PyTorch call computes these, so their library time is none;
   then K10 over the 7B temporal ring in three states and the depformer
   ring at each step, and at B = POOL_B with every session at another
   age (held by the RMS of its error per session, see ``TOL``), and K12
   in both forms at the temporal linear_out, with its control on an
   input with ties; then K3 (bf16 and fp8 rings) and K10 called twice in
   a row on their device's one workspace, the shapes changing between
   the pairs: both calls' bits equal, the workspace's sync region zero
   after them and the workspace the one the earlier calls left
   (``check_attention_workspace``), and so K9 (bf16 and fp8 rings) on the
   stt-1b and TTS rings (``check_k9_workspace``);
4. ``lm_gen_step`` with 2 layers of the 7B geometry at temp 0, the card's
   kernels against the CPU's plain versions on the same weights, for
   several weight seeds, in both forms of the mid-layer fusion
   (``MOSHI_TPU_FUSE_MID`` 1, the default, and 0), with the same kind of
   controls; then the full 32-layer 7B against the CPU for a few frames
   in the fused form; then the STT the same way: 2 layers of the stt-1b
   geometry for several seeds, and the full 16 layers for a few frames,
   transformer_out, the text logits and the VAD each within its limit and
   the decided text tokens equal, each with its controls; then 2 layers
   of the 7B geometry at B = POOL_B, sessions at POOL_B ages, card against
   CPU for SEEDS_POOL seeds, the decided tokens equal, with controls; then
   the TTS class with a synthetic voice (TTS_S speaker rows of width
   TTS_DW through ``voice_condition``): 2 layers at B = 1 for SEEDS_TTS
   seeds, 2 layers through ``TTSSessionPool`` at B = POOL_B with slots
   attaching at different ticks, and all 16 layers at B = 1, the CPU
   following the card's tokens, transformer_out, the text and depformer
   logits within their limits and the decided tokens equal, with
   controls; then 2 layers of the 7B geometry under
   MOSHI_TPU_MEGAKERNEL=all (K13, K14c) for SEEDS_MEGA seeds, fresh and
   on a full flat ring, and the dep_mega path (K14a) with its launches
   counted, card against CPU, with controls; then 2 layers of the 7B
   geometry under the sts_mxu knobs for SEEDS_2L seeds, fresh and on a
   full ring, and once under lm_split, the decided tokens equal, with
   controls;
5. the full 7B (32 layers) q4_k ``lm_gen_step`` at B = 1 in the fused
   form, in two session states: a fresh session, and one past its 3000th
   frame with every KV ring slot filled (so the attention reads the whole
   window); then fresh sessions in the unfused form twice and in the
   fused form again, so that the two forms run in turns; then the 7B
   under MOSHI_TPU_MEGAKERNEL=all in turns with the default form
   (megakernels, default, default, megakernels; per frame K13 1, K14c 1,
   K1 4 and nothing else), and on a full flat ring; then the 7B under
   the sts_mxu knobs in turns with the default form (per frame K10 80,
   K12 32, one launch a call, K1 90, K5 80, K2 48, K4 1, and no K3), on a
   full ring, and under lm_split fresh and on a full ring (K12's
   split-spread form in the k-segment form's place); then the full
   stt-1b ``lm_gen_step`` fresh and with a full 750-slot ring.  Each runs
   warm-up frames, then timed frames, each with its own ``other_audio``,
   synchronized and reduced to a token digest on the host, beside its HBM
   floor; the kernels' launch counts over each run are asserted against
   the counts one frame makes (the STT: K9 16, K11 16, one a layer for
   its k and v rings, nothing else);
6. the full-width Mimi (bf16, n_q 16) on the card against the CPU:
   streaming encode of distinct audio frames, and decode of their codes;
7. the STS frame, ``STSPipeline.step`` with the 7B q4_k LM and the full
   Mimi at the pipeline's sampling defaults: warm-up frames, then timed
   frames, each with its own input audio and a digest of its output audio
   and tokens fetched to the host, against the 80 ms real-time line, with
   the launch counts asserted; then a second run split into encode, LM
   and decode on the host clock; then the STT frame, ``STTPipeline.step``
   with Mimi encode at n_q 32 and the stt-1b LM, the same way (a digest of
   each frame's text token and VAD, which must follow the input; the
   split into encode and LM); then the offline scans and the streaming
   sessions ("sts_scan", "stt_scan", "session"): ``STSPipeline
   .scan_frames`` (the 7B, the sampling defaults) and ``STTPipeline
   .scan_frames`` (the stt-1b, text at temp 0.8) over SCAN_FRAMES frames
   (past one 125-frame Mimi chunk), each in SCAN_TURNS turns with its
   launches asserted and its outputs equal every turn, against the frame
   loop on the same work in the same process (Mimi's streaming steps,
   ``lm_gen_step`` on the scan's codes), all timed on the host clock:
   the offline codes equal to the streaming codes wherever the streaming
   quantizer decides them, the LM phase equal to the loop's bit for bit,
   the offline decode within ``TOL["scan_audio"]`` of the streaming
   decode, each Mimi check against two controls (``_MIMI_CONTROLS``);
   the scan's phases profiled (offline Mimi against streaming, launches
   and device ms a frame); 2 layers of the 7B and of the stt-1b geometry
   through the scans, card against CPU as phase 4 holds the frame; a
   scan entering a streaming state (its Mimi rings grown) against the LM
   phase alone on the same codes; ``LMGenerator`` on the 7B against
   ``lm_gen_step`` and ``MimiStreamer`` against ``encode_step`` /
   ``decode_step``, bit for bit (and, after the TTS frame, a TTS
   ``LMGenerator`` with the text StateMachine against
   ``TTSPipeline.step``, bit for bit); then the batched path:
   ``SessionPool.tick`` with POOL_B sessions of the 7B q4_k STS frame,
   attaching at different ticks, one detached and another attached in
   its slot mid-run,
   POOL_WARMUP + POOL_TICKS ticks against the 80 ms line with a digest of
   every session's output per tick, the launch counts asserted (per tick
   at B = 8: K6 2, K8 80, K2 248, K3 80, K4 1, and no K1 or K5), and the
   peak memory over the pool against its sessions' KV rings; then the
   TTS frame, ``TTSPipeline.step_device`` with a voice in q4_k (warm-up,
   then timed frames with a digest of each frame's audio and tokens, the
   launch counts asserted, against the 80 ms line and the LM's HBM floor)
   and in bf16 (the generic depformer); then ``TTSSessionPool`` with
   POOL_B slots of scripts of different lengths, the shortest draining
   and another session taking its slot, TTS_POOL_TICKS timed ticks and a
   ``tick_chunk``, the launch counts asserted per frame (K7 16 per tick),
   and the peak memory over the pool; then the STS frame under
   MOSHI_TPU_MEGAKERNEL=all (``STSPipeline.init_state`` given the LM
   weights, so the flat layout), its launches asserted; then the STS
   frame under the sts_mxu knobs, its launches asserted;
8. torch.profiler windows over a few more fresh-session LM frames in
   each fusion form (in turns: fused, unfused, unfused, fused), over a
   few STS frames, over a few STT frames, over one pool tick, one TTS
   frame (q4_k; the bf16 one is profiled in phase 7, while its weights
   are on the card, and the STT frame on fp8 rings in phase 9) and one
   TTS pool tick, over the LM and the STS frames under
   MOSHI_TPU_MEGAKERNEL=all, and over the LM frame under the sts_mxu
   knobs: device time by kernel, the device's busy share, host time by
   op; on the STT, TTS and TTS pool frames the kernels around each ring
   write (``check_ring_write_sequence``: no remainder or copy kernel
   between a layer's projection and its K11 launch, none but K9's own
   query cast between K11 and K9); then weights from files ("load",
   ``run_load``, its files in a temporary directory removed after): the
   7B q4_k tree through ``save_lm_gguf`` and ``load_lm_params`` on the
   card, every leaf equal to the in-memory one (its scales f16 values,
   checked), LOAD_FRAMES LM frames from each tree on one seed bit for bit
   equal with the 7B frame's launches; the full Mimi through
   ``save_mimi_gguf`` / ``load_mimi_params`` (its conv weights through
   f16, as the file stores them) and one encode and decode frame; then a
   bf16 safetensors file of a 7B-width LM of QLOAD_LAYERS layers loaded
   with ``fmt="q4_k"``, which builds the native quantizer here, the
   layers' q8_0 and q4_0 values against numpy's (equal but at exact ties,
   where the native rounds half away from zero) and q4_k within the JAX
   package's bound, with the file's size and the seconds of each step;
   then the TTS class with the demuxed text stream and depformer RoPE
   ("tts_demux"): 2 layers card against CPU through ``step_device`` (the
   device FSM muxing its second stream; the depformer's attention
   sharpened so that the rope decides), with two controls, the rope at
   the frame's offset and the second stream dropped, and the full 16
   layers with their launches asserted (the TTS frame's and K1 4 more);
9. fp8 KV rings: K4 into the 7B temporal rings of all 32 layers (B = 1
   and B = POOL_B, the shapes of its one call a frame or a tick) and K11
   into the stt-1b ring against their plain versions bit for bit
   on rows that hold every e4m3 tie, subnormals, 448, 464, values past
   464 and ±inf (NaN in the same places; the card's cast rule against
   the CPU's; PyTorch's saturating cast as the control), K3 over the
   full 7B ring and at POOL_B session ages and K9 over the stt-1b ring in
   its three states at their bf16 instances' limits and controls, each
   timed beside its plain version, the ring widened then SDPA, or
   ``.to(fp8)`` then an index copy, and its bound; then card against CPU
   on fp8 rings (``_fp8_check``, which logs the seconds the card, the
   CPU and the controls took): 2 layers of the 7B geometry for
   SEEDS_FP8 seeds across the ring's wrap, 2 layers at B = POOL_B at
   ``pool_offsets``' ages, all 32 layers for FRAMES_32L_FP8 frames of a
   long session (every layer reads its whole fp8 window) and 2 layers of
   the stt-1b geometry across its wrap,
   each held to its fp8 limit with its controls (the CPU following the
   card's text and depformer tokens, so that a near-tie does not change
   a later input), and its rings held by the flip rule
   (``fp8_ring_check``: every
   element the card wrote is the rule's rounding of a value within
   ``TOL["fp8_shift"]`` of the CPU's f32 value, relative to the write's
   largest value, and at 2 layers the flips' share is within
   ``TOL["fp8_flips"]``, which the
   rows-through-bf16 control exceeds); then the 7B LM frame on a full
   fp8 ring, the STS frame, the pool (its peak memory against
   ``memory.KV_TRANSIENT`` for both ring types, ``fp8_memory``) and the
   STT frame on fp8 rings, each with its launches asserted (per frame:
   K3 fp8 32 and K3 48 for the depformer, K4 fp8 1, with the rest of the
   STS frame's; per pool tick the same; the STT: K9 fp8 16, K11 fp8 16).
10. the last two kernel forms.  "sts_i8": K1 on i8 weights at every
   product the frame gives it and on a synthesized q4_0 weight (the
   scale-only epilogue), K5 on i8 weights at the temporal and depformer
   shapes, each against its plain version with K1's or K5's limit and
   control and against the packed weights' kernel, bit for bit on q4_k,
   timed in turns with it; the 32-layer frame on i8 weights against the
   packed frame, bit for bit at temp 0 and at the sampling defaults; the
   LM frame in turns with the packed weights' (per frame K1 i8 244, K5
   i8 80, K2 48, K3 80, K4 1) and the STS frame, with the launches
   asserted and the peak memory.  "sts_mega_fp8": K13 on fp8 flat rings
   (``check_k13``'s three cases) against its plain version at K13's
   limits and controls, against its bf16 instance on the rings widened
   (bit for bit) and its rows against the plain version's (a flip at a
   tie at most), with a probe whose rows pass 464 (NaN where the plain
   version's are; a saturating cast the control); 2 layers under
   ``all`` on fp8 flat rings card against CPU, its rings by phase 9's
   flip rule; the LM frame fresh and on a full fp8 ring and the STS
   frame under ``all`` (per frame K13 fp8 1, K14c 1, K1 4).

K3 and K9 are held by a flip rule (``flip_score``, see ``TOL``) wherever
they are checked.

The lines before the last are the kernel table as one JSON object
(``{"kernels": [...]}``: twenty-three entries, K1-K14 with K12's two
forms, K14c and K14a, the fp8 forms of K3, K4, K9, K11 and K13, and the
i8 forms of K1 and K5, each with its ``path``, "sts", "stt", "pool",
"tts_pool", "sts_mega", "dep_mega", "sts_mxu", "lm_split", "sts_fp8",
"stt_fp8", "sts_i8" or "sts_mega_fp8",
``launches`` per frame of that path's frame (a
tick for a pool), and ``paths``, its launches per frame on every path
that launches it, "tts", "sts_scan", "stt_scan", "session" (a frame
of a scan, an ``LMGenerator`` frame), "load" and "tts_demux" among them) and the card's ``name,
power.limit``; the last is ``{"ok": true, "device": {...}}``.
``--out F`` also writes every number of the run to the JSON file F.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the moshi 7B delays (text stream, then 16 audio streams)
_7B_DELAYS = (0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"int8": 1979e12,       # dense tensor-core rates, H100 SXM
            "bf16": 989e12,
            "f32": 67e12}          # outside the tensor cores

SEED = 0
WARMUP = 3          # frames before the timed ones, per session state
FRAMES = 12         # timed frames per session state
REPS = 20           # timed launches per kernel and shape
DRAWS = 4           # input draws per kernel check
SEEDS_2L = 1        # weight seeds of the 2-layer card-vs-CPU comparison
FRAMES_2L = 3       # frames per seed there
FRAMES_32L = 2      # frames of the 32-layer card-vs-CPU comparison
PROFILE_FRAMES = 2
MIMI_FRAMES = 4     # full-width Mimi frames, card against CPU
STS_WARMUP = 3      # STS frames before the timed ones
STS_FRAMES = 12     # timed STS frames (and frames of the split run)
REALTIME_MS = 80.0  # one frame of audio
# the speech-to-text configuration (the stt-1b-en_fr parameter class)
STT_CONFIG = Path(__file__).resolve().parent / "configs" / "bench" / \
    "stt-1b-class.json"
FRAMES_STT_FULL = 3  # frames of the 16-layer STT card-vs-CPU comparison
POOL_B = 8          # sessions of the batched path (SessionPool)
POOL_M_EXTRA = 12   # K6 and K8 are also checked at this many rows
POOL_WARMUP = 3     # pool ticks before the timed ones
POOL_TICKS = 12     # timed pool ticks
SEEDS_POOL = 1      # weight seeds of the B = POOL_B 2-layer comparison
TTS_ROWS = (2, 8)   # K1's row counts checked (MOSHI_TPU_INT8_MAX_M > 1)
TTS_S, TTS_DW = 8, 512   # synthetic voice: speaker rows and their width
SEEDS_TTS = 1       # weight seeds of the 2-layer TTS comparison
FRAMES_TTS_2L = 2   # frames per seed there
FRAMES_TTS_FULL = 1  # frames of the 16-layer TTS comparison
TTS_POOL_TICKS_2L = 2  # ticks of the B = POOL_B 2-layer TTS comparison
TTS_WARMUP = 3      # TTS frames before the timed ones (q4_k)
TTS_FRAMES = 12     # timed TTS frames (q4_k)
TTS_BF16_WARMUP = 1  # bf16 TTS frames before the timed ones
TTS_BF16_FRAMES = 4  # timed bf16 TTS frames
TTS_POOL_WARMUP = 3  # TTS pool ticks before the timed ones
TTS_POOL_TICKS = 34  # timed TTS pool ticks (the shortest script drains)
TTS_CHUNK = 4       # frames of the pool's tick_chunk after the ticks
TTS_MAX_TOKENS = 128  # the TTS pool's script capacity (tokens, entries)
SEEDS_MEGA = 1      # weight seeds of the 2-layer megakernel comparison
PLAIN_MEMO_BYTES = 32 * 2 ** 30  # CPU plain weights kept per comparison
LOAD_FRAMES = 2     # 7B LM frames from the loaded tree and the in-memory one
QLOAD_LAYERS = 2    # 7B-width temporal layers of the quantize-on-load file
TTS_DEMUX_FRAMES_2L = 3  # step_device frames of the 2-layer tts_demux check
TTS_DEMUX_WARMUP = 2  # full-depth tts_demux frames before the timed ones
TTS_DEMUX_FRAMES = 4  # timed full-depth tts_demux frames
FP8 = "float8_e4m3fn"  # LMConfig.kv_dtype of the fp8 paths
SEEDS_FP8 = 1       # weight seeds of the 2-layer fp8 comparison
FRAMES_FP8 = 2      # frames per seed there (half before the ring's wrap)
FRAMES_FP8_POOL = 2  # ticks of the B = POOL_B fp8 comparison
FRAMES_32L_FP8 = 1  # frames of the 32-layer fp8 comparison (full window)
MEGA_K14A_CARD = 2016  # dep_mega's card: not a multiple of 128, so K14a
FRAMES_I8 = 3       # frames of the i8-against-packed 32-layer comparison
SCAN_FRAMES = 130   # frames of the full-width scans: past one Mimi chunk (125)
SCAN_TURNS = 2      # scans of the clip, each timed, their outputs equal
SCAN_FRAMES_2L = 2  # frames of the 2-layer scans, card against CPU
SCAN_LEAD = 3       # streaming frames before the mid-stream scan
SCAN_MID_FRAMES = 24  # frames the mid-stream scan takes after them
SCAN_PROFILE_FRAMES = 3  # frames of the scan's LM phase under the profiler
SESSION_FRAMES = 16  # LMGenerator frames on the 7B
TTS_SESSION_FRAMES = 24  # on the TTS class: past its 16-frame lead-in
STREAMER_FRAMES = 4  # MimiStreamer frames against encode_step / decode_step

# Limits, relative to the reference's largest value.  Each sits between
# the largest reading of the sound code and the smallest reading of a
# control that changes one rounding (PERF.md lists both):
# - int8_matvec: kernel and plain version form the same int8 activation
#   and integer dots and differ in the f32 order of the scale sums (~2e-7),
#   except where a last-bit difference in the fused rms-norm flips one
#   activation's rounding (~3e-4 each).  Control: each block's scaled
#   partial rounded to bf16 before the sum (>= 1.4e-3).
# - dequant_matvec: bf16 x bf16 products exact in f32; sum order only
#   (~2e-7).  Control: each product rounded to bf16 (~1.7e-3).
# - decode_attention: scores summed in another order move a few bf16
#   probabilities by one step (<= 2.7e-4 on a full ring).  Control:
#   probabilities not rounded to bf16 (>= 1.0e-3).  One step of a large
#   p, confined to one head, can reach the limit by itself: on 20 seeds
#   of phase 9's full-ring draws (``k3_seed_scan.py``) K3 read 2.2e-5 to
#   5.04e-4, one seed above 5e-4, its bf16 and fp8 instances alike.  So
#   K3 and K9 are held by a flip rule (``flip_score``): per session every
#   head but the worst within the limit, and the worst within the limit
#   plus what one flipped probability can move it (``flip_bound``: one
#   bf16 step of its largest weighted value); the control (p in f32)
#   moves every head and must break the rule.
# - fp8_widen: K3 on fp8 rings against its bf16 instance on the same
#   rings widened (exact): the same scores and p, the value pass's
#   partial sums grouped otherwise (<= 2.5e-7 on those 20 seeds).
# - fp8_* (phase 9, card against CPU on fp8 rings; sound / control): the
#   frames' class (int8 roundings flipped downstream of a last-bit
#   difference), over fewer frames than phase 4's, so with less room:
#   fp8_2l 3.28e-3 / K1 bf16 partials 4.13e-3; fp8_pool_2l 1.56e-3 / K3
#   p in f32 3.44e-3; fp8_32l (one frame reading every layer's whole fp8
#   window) 5.61e-3 / K1 bf16 partials 6.65e-3; fp8_stt_2l 9.87e-4 / K9
#   p in f32 1.81e-3; the depformer limits above the sound readings, as
#   frame_2l_dep.  The rings (``fp8_ring_check``): fp8_shift, a flipped
#   element's distance from the tie, sound <= 7.1e-4 at 2 layers and
#   3.98e-3 at 32 (fp8_shift_32l), truncation >= 3.5e-2; fp8_flips, the
#   flips' share at 2 layers, sound <= 2.32e-3, rows rounded through
#   bf16 first >= 5.40e-3.  Both sides deterministic on one card type.
# - frame (the larger of transformer_out's and the text logits' errors,
#   card against CPU; every token must agree too): any last-bit
#   difference flips int8 activation roundings downstream, so the sound
#   readings are far above f32 rounding, and grow with depth.  Controls:
#   the CPU side with the K1 or the K3 control above.  At 32 layers the
#   two lie within 1.6x of each other, so that limit has little room on
#   either side; both runs are deterministic on one card type.
# - frame, the depformer's logits: its carry is bf16, so a last-bit
#   difference that straddles a bf16 rounding moves a whole element by
#   2^-8; the sound readings sit at 5-9e-3 and above some controls'.
#   Their limit is above the sound readings; the controls are told apart
#   by transformer_out and the text logits.
# - attn_ffn_fused (K5): K1's arithmetic twice, h_mid in f32 between; the
#   same class as K1's fused-norm GLU (~3e-4 where a last-bit difference
#   in the norm flips an int8 rounding).  Control: h_mid rounded to bf16
#   before norm2, the unfused depformer's rounding (>= 4e-3).
# - decode_attention4 (K9): K3's arithmetic without the seed, the same
#   class (scores summed in another order flip a few bf16 probabilities:
#   <= 8.8e-5 at the stt-1b ring).  Controls: p in f32 (>= 1.2e-3) in every
#   ring state, K3's context - 1 mask (2.1e-2) on the wrapped rings, and
#   K3's chunking on a ring built so that the chunking decides a rounding
#   (``k9_boundary_case``: about 6e-3).  On random rings K3's chunking is
#   logged, not held (1.7e-4 to 3.8e-4: it moves only the slots between
#   the two chunkings' boundaries).
# - dense_mm: one cuBLAS call with bf16 operands and an f32 output against
#   both operands widened to f32; the same exact products, summed in
#   another order (~2.9e-6 at K = 2048 and 8448).
# - stt_frame (the larger of transformer_out's and the text logits'
#   errors, card against CPU; the decided text tokens must agree): every
#   product rounds its activation to bf16 first, so a last-bit difference
#   in a sum flips some of those roundings (~1e-4 per product), and the
#   stack carries them: sound <= 5.3e-4 at 2 layers, 1.9e-3 at 16.
#   Controls: K9's p in f32 (1.0e-3 at 2 layers) and every dense product
#   rounded to bf16 (3.6e-3 at 2 layers, 3.5e-3 at 16).  At 16 layers K9's
#   control reads within the sound readings' spread (2.1e-3), so, as K3's
#   at 32 layers of the 7B, it is held at 2 layers only.
# - stt_vad: the VAD's error rides on transformer_out's (<= 7.3e-5); its
#   limit is above the sound readings, and the controls are told apart by
#   transformer_out and the logits.
# - mimi_audio: the card's cuDNN convolutions and matmuls round each
#   output to bf16 where the CPU's do; they differ where the two f32 sums
#   straddle a bf16 rounding boundary.  Codes must agree where the
#   top-1/top-2 score gap exceeds mimi_gap of the row's largest |score|.
# - qmatmul (K6) and glu_matvec (K8): K2's arithmetic, so K2's class (sum
#   order only, <= 3.8e-6 at B = 8; K8's silu takes expf on the card and in
#   PyTorch's plain version alike).  dequant_norm: K2 and K6 with the rms
#   pre-norm fused (at B > 1 only): the kernel's and the plain version's
#   norms differ in the last bit, which flips a few bf16 activation
#   roundings (<= 2.7e-4), K1's class.  Controls: the weight elements left
#   in f32 (>= 2.0e-3).
# - K8 and K7 with the norm fused: the GLU multiplies two sums that one
#   flipped activation both moves, so a single flip reads up to 1.4e-3
#   against the plain version (the TTS pool's depformer GLU), within
#   reach of the control (the gate rounded to bf16, >= 2.1e-3): no limit
#   on that reading tells the two apart.  So the check holds the kernel
#   on its own staged activations (``GluNorm``; read back exactly through
#   K6 on an identity weight, ``staged_activations``): the error against
#   the plain version on them at glu_matvec's limit, and every staged
#   activation that differs from the plain norm's rounding must be its
#   other bf16 neighbour, the plain norm's f32 value within norm_tie of
#   the boundary between the two, relative (the two norms differ by their
#   sum order and their sqrt).  The reading against the plain version is
#   logged beside it.
# - pool_2l / pool_2l_dep (2 layers of the 7B at B = 8, card against CPU,
#   sessions at 8 ages; decided tokens must agree): every product takes
#   the dequant kernels and rounds its activation to bf16, so a last-bit
#   difference in a sum flips some of those roundings (sound <= 2.14e-3),
#   and the depformer's bf16 carry moves a whole element where it does
#   (<= 2.8e-3).  Controls: K3's p in f32 (3.5e-3) and the dequant
#   activations in f32 (2.9e-3).  As at 32 layers of the B = 1 frame the
#   limit has little room on either side; the runs are deterministic on
#   one card type.
# - glu_matmul (K7): K8's kernel on a flat weight, so K8's limits and
#   controls: glu_matvec without the norm (<= 1.8e-6), and with it on
#   its staged activations.
# - tts_2l / tts_2l_dep (2 layers of the TTS class at B = 1 from a full
#   500-slot ring, card against CPU with the CPU forced to the card's
#   tokens): the generic layers' products flip no rounding here (sound
#   transformer_out and text logits <= 2.2e-7); the depformer's bf16
#   carry reads <= 2.3e-3 (3.7e-3 on fresh sessions).  Controls: K1's
#   partials (logits 1.9e-3), K9 and K3 p in f32 (logits 3.8e-4,
#   depformer 6.3e-3), K5's h_mid in bf16 (depformer 5.6e-3).
# - tts_pool_2l / tts_pool_2l_dep (2 layers through TTSSessionPool at
#   B = 8): sound <= 4.8e-7 and depformer 8.0e-4; controls K3 / K9 p in
#   f32 (logits 6.7e-4, depformer 2.5e-3) and the dequant activations in
#   f32 (2.6e-3, 2.6e-3).
# - tts_full / tts_full_dep (all 16 layers at B = 1, 2 frames): sound
#   8.1e-6 and depformer 3.4e-3; the 2-layer checks hold the controls.
# - temporal_full_step (K13, all 32 layers of the 7B; the dequant
#   arithmetic, so a last-bit difference in a sum flips a bf16 activation
#   rounding, and 32 layers carry them): fresh ring sound 6.7e-6, control
#   the weight elements left in f32 3.1e-5; temporal_full_step_full (the
#   full 3000-slot ring): sound 2.8e-5, controls weights in f32 7.7e-5,
#   p in f32 7.4e-5, the bf16 products left exact (K14's form) 6.6e-5;
#   temporal_full_step_2l (2 layers, full ring), where the attention's
#   roundings stand apart: sound 7.5e-7, the same controls 1.8e-5 to
#   1.8e-5.
# - mega_kv: the k/v rows K13 returns and K14a writes (bf16), each element
#   within one bf16 step of the plain version's or within this share of
#   the rows' largest value: a flipped bf16 activation rounding before
#   a layer's qkv product moves a row by about 1e-4 of its largest value.
# - dep_full_step (K14a, the 7B depformer's 6 layers, steps 0-7): sound
#   1.5e-7 (a flipped activation rounding can read ~7e-5), controls
#   weights in f32 4.8e-4, p * v rounded to bf16 (K13's form) 4.7e-4.
# - dep_frame_step (K14c's logits over the 8 steps): sound 1.9e-6,
#   controls weights in f32 2.6e-3, p * v rounded 1.5e-5.
# - mega_2l / mega_2l_dep (2 layers of the 7B under MOSHI_TPU_MEGAKERNEL=
#   all, card against CPU, the CPU following the card's tokens): the text
#   head's and the depformer input's K1 round their activations to int8,
#   so the card's and the CPU's last bits move whole int8 steps: sound
#   transformer_out and text logits <= 3.3e-3, depformer <= 5.0e-3;
#   controls weights in f32 4.8e-3 (logits), K13 p in f32 6.2e-3.  K14's
#   p * v control moves the depformer logits (2.6e-3) less than that
#   spread: phase 3 holds it.  dep_mega_2l_dep: the K14a path's depformer
#   logits (through K1, after the stacked int8 temporal stack) 4.6e-3.
#   These limits have little room on either side; both runs are
#   deterministic on one card type.
# - decode_attention_mxu (K10): K3's arithmetic with q * scale, p and each
#   chunk's p . v rounded to bf16.  A last-bit difference in a chunk's f32
#   p . v sum flips its bf16 rounding and moves that one element by one
#   bf16 step of the chunk's contribution (<= 2.1e-3 of the largest value:
#   decode_attention_mxu_max, 5e-3), as far as a control moves every
#   element; so the limit is on the RMS of the error per session
#   (``rms_rel``): sound <= 8.1e-5 (a partly filled 7B ring), controls
#   (K3's function, p . v in f32, the scale after the sum, K3's chunk)
#   >= 3.4e-4.
# - int8_kseg / int8_split (K12): K1's activation and integer dots, the
#   f32 order of the block terms' sums alone (<= 1.9e-7).  Control: the
#   block scale as a quotient, on an input with ties (9.7e-3).
# - mxu_2l / mxu_2l_dep / mxu_2l_rms (2 layers of the 7B under the knobs,
#   card against CPU, the CPU from the card's delay cache): K10's flipped
#   p . v roundings reach K1's int8 roundings, which carry them, so the
#   largest errors (transformer_out and logits <= 4.8e-3, depformer
#   <= 8.3e-3) read as high as the controls'; their limits sit above the
#   sound readings and decide which tokens must agree.  Held: the RMS of
#   transformer_out, sound <= 1.27e-4 (full ring), controls (K10's p . v
#   in f32, its scale after the sum, K3 in its place, K1's bf16
#   partials) >= 1.72e-4.  Little room on either side; both runs are
#   deterministic on one card type.
# - scan_audio (the offline STS scan's decode against the streaming
#   decode of the same tokens, ``run_scan``; relative to the clip's
#   largest value): the streaming ring of context slots drops a key the
#   offline ring keeps, and the bf16 convs at another length round apart:
#   sound 2.725e-3 over the 130-frame clip (each frame 1.8e-3 to 3.0e-3,
#   the first 1.5e-6).  Controls, the offline Mimi with one fault of its
#   transformers (``_MIMI_CONTROLS``): the T > 1 mask without its causal
#   bound 5.460e-3, the transformers passed over 1.098e-2.  The offline
#   codes are held as the card's against the CPU's are
#   (``decided_codes``): every code the streaming quantizer decides (gap
#   > mimi_gap) equal; sound 1600/1600 (STS) and 2547/2547 (STT), the
#   controls break it (1585/1600, 1462/1600; 2528/2547, 2124/2547).
#   Both sides deterministic on one card type.
# - tts_demux_2l / tts_demux_2l_dep (2 layers of the TTS class with the
#   demuxed text stream and depformer RoPE at B = 1, ``step_device`` card
#   against CPU over 3 fresh frames, the CPU following the card's tokens,
#   the depformer's attention sharpened, ``sharpen_depformer``): sound
#   transformer_out 4.1e-7, text logits 2.2e-7, depformer logits 1.16e-2
#   (the sharpened softmax amplifies a bf16 rounding of k or p;
#   unsharpened the TTS class reads 1.4e-3).  Controls: the rope at the frame's offset moves
#   the depformer logits 2.13e-1; the second stream dropped moves
#   transformer_out 8.0e-4, the text logits 2.4e-3 and the depformer
#   logits 1.15e-1.  The depformer's limit (3e-2) sits 2.6x above its
#   reading and 3.8x below the nearest control; the TTS class's 1e-4
#   holds transformer_out and the text logits, which the second-stream
#   control moves 8x and 24x past it.
TOL = {"int8_matvec": 7e-4, "dequant_matvec": 1e-5,
       "decode_attention": 5e-4, "attn_ffn_fused": 7e-4,
       "decode_attention4": 5e-4, "dense_mm": 1e-5,
       "qmatmul": 1e-5, "glu_matvec": 1e-5, "dequant_norm": 7e-4,
       "norm_tie": 2e-6,
       "stt_frame_2l": 7e-4, "stt_frame_16l": 2.5e-3, "stt_vad": 1.5e-4,
       "frame_2l": 2e-3, "frame_32l": 7e-3,
       "frame_2l_dep": 1e-2, "frame_32l_dep": 1.2e-2,
       "pool_2l": 2.5e-3, "pool_2l_dep": 5e-3,
       "tts_2l": 1e-4, "tts_2l_dep": 5e-3, "tts_full": 1e-4,
       "tts_full_dep": 5e-3, "tts_pool_2l": 1e-4,
       "tts_pool_2l_dep": 1.5e-3,
       "mimi_audio": 5e-3, "mimi_gap": 1e-3,
       "temporal_full_step": 1.5e-5, "temporal_full_step_full": 4.5e-5,
       "temporal_full_step_2l": 5e-6, "dep_full_step": 1e-4,
       "dep_frame_step": 6e-6, "mega_kv": 1e-3, "mega_2l": 4e-3,
       "mega_2l_dep": 6e-3, "dep_mega_2l_dep": 1e-2,
       "decode_attention_mxu": 2e-4, "decode_attention_mxu_max": 5e-3,
       "int8_kseg": 2e-6, "int8_split": 2e-6,
       "mxu_2l": 6e-3, "mxu_2l_dep": 1.2e-2, "mxu_2l_rms": 1.5e-4,
       "fp8_flips": 2.5e-3, "fp8_shift": 3e-3, "fp8_shift_32l": 8e-3,
       "fp8_2l": 3.7e-3, "fp8_2l_dep": 1.5e-2, "fp8_pool_2l": 2.5e-3,
       "fp8_pool_2l_dep": 5e-3, "fp8_32l": 6.1e-3, "fp8_32l_dep": 1.2e-2,
       "fp8_stt_2l": 1.4e-3, "fp8_widen": 1e-6,
       "scan_audio": 4e-3,
       "tts_demux_2l": 1e-4, "tts_demux_2l_dep": 3e-2}

DEV = "cuda"     # a CPU rehearsal of the control flow may set "cpu"
CARD = ""        # nvidia-smi's "name, power.limit", printed beside times
_FLUSH = None


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` launches, each between
    two CUDA events.  Before each, a 1 GiB write flushes the 50 MB L2 (the
    frame reads every weight once, so it finds them cold) and keeps the
    device busy for about 0.3 ms while the host enqueues the events and
    the launch, so the host's own time stays out of the window."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(2 ** 30, dtype=torch.uint8, device=DEV)
    fn(0)
    torch.cuda.synchronize()
    evs = []
    for i in range(reps):
        _FLUSH.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def tree_to(tree, device):
    """A parameter tree (tensors and QuantTensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 3: each kernel at the frame's shapes against its plain version
# ---------------------------------------------------------------------------

def _qt_layer_bytes(qt, rows: int) -> int:
    """Bytes of ``rows`` rows of one layer: the values in their storage
    (packed nibbles, or int8) and the bf16 scales the kernels read (es/em
    for q4_k, d otherwise)."""
    k = qt.shape[-1]
    vals = rows * (k if qt.unpacked else k // 2)
    nscale = 2 if qt.fmt == "q4_k" else 1
    return vals + rows * (k // 32) * 2 * nscale


def _first_layers(qt, n: int):
    """The first ``n`` layers of a stacked QuantTensor as [n, O, ...]."""
    lead = qt.q.dim() - 2
    return qt._map(lambda a: a.reshape((-1,) + tuple(a.shape[lead:]))[:n])


def _matvec_cases(params, cfg):
    """(name, weight, layers, x dtype, norm alpha, glu, calls per frame in
    the fused form, calls per frame in the unfused form) for every
    quantized matvec of the frame.  In the fused form K5 takes the
    out_proj and linear_in (GLU) of every layer."""
    lay = params["transformer"]["layers"]
    dep = params["depformer"]
    dl = dep["layers"]
    nl, dnl, dq = cfg.num_layers, cfg.depformer_layers, cfg.dep_q
    n1t = dl["norm1"]["alpha"].repeat(dq, 1)
    n2t = dl["norm2"]["alpha"].repeat(dq, 1)
    from moshi_tpu_torch.quant.formats import flatten_lead
    f32, bf = torch.float32, torch.bfloat16
    return [
        ("temporal in_proj", lay["self_attn"]["in_proj"]["weight"], nl, f32,
         lay["norm1"]["alpha"], False, nl, nl),
        ("temporal out_proj", lay["self_attn"]["out_proj"]["weight"], nl, bf,
         None, False, 0, nl),
        ("temporal linear_in (GLU)", lay["gating"]["linear_in"]["weight"], nl,
         f32, lay["norm2"]["alpha"], True, 0, nl),
        ("temporal linear_out", lay["gating"]["linear_out"]["weight"], nl, bf,
         None, False, nl, nl),
        ("text head", params["text_linear"]["weight"], 1, f32, None, False,
         1, 1),
        ("depformer in", flatten_lead(dep["in"]["weight"]), 1, bf, None,
         False, 1, 1),
        ("depformer in_proj", dl["self_attn"]["in_proj"]["weight"], dq * dnl,
         bf, n1t, False, dq * dnl, dq * dnl),
        ("depformer out_proj", dl["self_attn"]["out_proj"]["weight"],
         dq * dnl, bf, None, False, 0, dq * dnl),
        ("depformer linear_in (GLU)", dl["gating"]["linear_in"]["weight"],
         dq * dnl, bf, n2t, True, 0, dq * dnl),
        ("depformer logits", dep["linears"]["weight"], dq, bf, None, False,
         dq, dq),
        ("depformer linear_out", dl["gating"]["linear_out"]["weight"],
         dq * dnl, bf, None, False, dq * dnl, dq * dnl),
    ]


@contextlib.contextmanager
def swapped(module, name, value):
    """``module.name`` replaced by ``value`` inside the block (a control:
    one plain version with one rounding changed)."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _bf16_round(t):
    return t.to(torch.bfloat16).float()


def int8_control(x, qt, layer, alpha=None, glu=False):
    """K1's plain version with each block's scaled partial (es*dx*P -
    em*xs for q4_k; d*dx*P where the values carry their zero point: q8_0,
    unpacked q4_0) rounded to bf16 before the row sum; x [K] or [m, K]."""
    from moshi_tpu_torch.quant import matmul_int8 as mi
    if qt.fmt != "q4_k" and not qt.unpacked:
        raise ValueError(f"the K1 control covers q4_k and unpacked values, "
                         f"not packed {qt.fmt}")
    xq, dx, xs = mi.quantize_activation(x, alpha)
    rows = qt.q.shape[-2]
    p = torch.einsum("obk,...bk->...ob", mi.block_values(qt, layer), xq) \
        * dx[..., None, :]
    if qt.fmt == "q4_k":
        es = mi.layer_rows(qt.es, rows, layer).float()
        em = mi.layer_rows(qt.em, rows, layer).float()
        y = _bf16_round(es * p - em * xs[..., None, :]).sum(dim=-1)
    else:
        d = mi.layer_rows(qt.d, rows, layer).float()
        y = _bf16_round(d * p).sum(dim=-1)
    if glu:
        gate, val = y[..., : rows // 2], y[..., rows // 2:]
        y = gate * torch.sigmoid(gate) * val
    return y


def fused_control(attn, hcur, out_qt, glu_qt, alpha, layer):
    """K5's plain version with h_mid rounded to bf16 before norm2 (the
    unfused depformer's rounding of its bf16 carry)."""
    from moshi_tpu_torch.quant import matmul_int8 as mi
    h_mid = _bf16_round(hcur.float() + mi.int8_matvec_plain(attn, out_qt,
                                                            layer))
    return mi.int8_matvec_plain(h_mid, glu_qt, layer, alpha, glu=True), h_mid


@contextlib.contextmanager
def reused_plain_weights():
    """The CPU plain versions' weight operands (``block_values`` of K1,
    K5 and K12, ``dequantized_f32`` of the dequant products and the
    megakernels) formed once per weight and layer inside the block and
    reused by every later frame and control, instead of being unpacked
    again at each call.  An entry is keyed by the storage address and
    in-place version of each of the QuantTensor's arrays (and holds them,
    so that no address is reused), so a weight changed in place is formed
    anew; the values are the same bits.  Only CPU weights are kept, up to
    PLAIN_MEMO_BYTES; the entries go when the block ends."""
    from moshi_tpu_torch.quant import matmul as mm
    from moshi_tpu_torch.quant import matmul_int8 as mi
    memo, held = {}, [0]

    def kept(fn, layout):
        def operand(qt, layer):
            if qt.q.device.type != "cpu":
                return fn(qt, layer)
            arrays = tuple(a for a in (qt.q, qt.d, qt.sc, qt.mn, qt.dmin,
                                       qt.es, qt.em) if a is not None)
            key = (fn, qt.fmt, qt.unpacked, layer, tuple(
                (a.data_ptr(), a._version, tuple(a.shape), a.dtype)
                for a in arrays))
            hit = memo.get(key)
            if hit is not None:
                return hit[1]
            w = layout(fn(qt, layer))
            size = w.numel() * w.element_size()
            if held[0] + size <= PLAIN_MEMO_BYTES:
                memo[key] = (arrays, w)
                held[0] += size
            return w
        return operand

    def block_major(w):
        # [O, K/32, 32] viewed over a [K/32, O, 32] array: the block dots'
        # einsum reads it without a copy
        return w.permute(1, 0, 2).contiguous().permute(1, 0, 2)

    with swapped(mi, "block_values", kept(mi.block_values, block_major)), \
            swapped(mm, "dequantized_f32", kept(mm.dequantized_f32,
                                                lambda w: w)):
        try:
            yield
        finally:
            memo.clear()


@contextlib.contextmanager
def k1_control():
    """K1's control in every plain path that runs K1's arithmetic (the
    int8 matvec and K5, which calls it twice)."""
    from moshi_tpu_torch.quant import fused
    from moshi_tpu_torch.quant import matmul_int8 as mi
    with swapped(mi, "int8_matvec_plain", int8_control), \
            swapped(fused, "int8_matvec_plain", int8_control):
        yield


@contextlib.contextmanager
def env_set(name: str, value: str):
    """The environment variable ``name`` set to ``value`` inside the block
    and restored after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def fusion(form: str):
    """The mid-layer fusion switch (MOSHI_TPU_FUSE_MID) set to ``form``
    inside the block."""
    return env_set("MOSHI_TPU_FUSE_MID", form)


def dequant_control(x, qt, layer):
    """K2's plain version (q4_0 / q8_0, no norm) with each product
    rounded to bf16 before the f32 sum."""
    from moshi_tpu_torch.quant.matmul import dequantize_layer_bf16
    w = dequantize_layer_bf16(qt, layer).float()
    xb = _bf16_round(x.float())
    return _bf16_round(xb[:, None, :] * w[None]).sum(dim=-1)


def rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / max(float(ref.float().abs().max()), 1e-30))


def check_limit(what, kernel, reading, control):
    tol = TOL[kernel]
    if not reading <= tol:
        fail(f"{what}: relative error {reading:.3e} > {tol:g}")
    if not control > tol:
        fail(f"{what}: the control reads {control:.3e}, within the limit "
             f"{tol:g}: the check cannot tell that rounding apart")


# One flipped bf16 rounding of a probability moves it by one bf16 step,
# at most 2^-7 of its value.
FLIP_STEP = 2.0 ** -7


def flip_bound(q, k, v, offset, *, cap: int, context: int, cur_k=None):
    """[B, H]: how far one flipped bf16 rounding of a probability can move
    each head's output of K3 (``cur_k`` given: the ring before the write,
    slots with delta < context - 1, the current token its seed, whose
    weight is no rounded p) or K9 (the ring after the write, delta <
    context): FLIP_STEP times the largest w_j * |v_j| over the head's
    slots and dims, w its exact softmax weights.  A flip of p_j moves the
    output by at most one step of p_j, scaled as p_j is, so by
    FLIP_STEP * w_j * |v_j|."""
    hd = q.shape[-1]
    qf = q.to(torch.bfloat16).float()
    s = torch.einsum("bjhd,bhd->bjh", k.float(), qf) * hd ** -0.5
    off = offset.to(q.device).long()
    seeded = cur_k is not None
    last = off - 1 if seeded else off
    r = torch.remainder(last, cap)[:, None]
    j = torch.arange(cap, device=q.device)[None]
    delta = torch.where(j > r, r - j + cap, r - j)
    valid = ((delta < (context - 1 if seeded else context))
             & (last[:, None] - delta >= 0))
    s = s.masked_fill(~valid[..., None], float("-inf"))
    top = s.amax(1)
    if seeded:
        s_cur = (cur_k.float() * qf).sum(-1) * hd ** -0.5
        top = torch.maximum(top, s_cur)
    e = torch.exp(s - top[:, None])
    total = e.sum(1) + (torch.exp(s_cur - top) if seeded else 0.0)
    w = e / total[:, None]
    return FLIP_STEP * (w[..., None] * v.float().abs()).amax(dim=(1, 3))


def flip_score(got, ref, bound, tol: float) -> float:
    """K3's and K9's rule, as one reading: per session, every head but the
    one with the largest error within ``tol`` of the output's largest
    value, and that head within ``tol`` plus what one flipped probability
    can move it (``bound``, ``flip_bound``'s, relative to the same
    value).  The reading is the largest over sessions of max(rest / tol,
    worst / (tol + its bound)); the rule holds at <= 1."""
    scale = max(float(ref.float().abs().max()), 1e-30)
    err = (got.float() - ref.float()).abs().amax(-1) / scale       # [B, H]
    b = bound.to(err.device).float() / scale
    worst = err.argmax(-1, keepdim=True)
    rest = err.scatter(-1, worst, 0.0).amax(-1)
    ratio = torch.maximum(rest / tol, err.gather(-1, worst)[:, 0]
                          / (tol + b.gather(-1, worst)[:, 0]))
    return float(ratio.max())


def check_rule(what, kernel, reading, control):
    """Hold K3's or K9's ``flip_score`` reading (at TOL[kernel]) within 1,
    and its control's above 1."""
    if not reading <= 1.0:
        fail(f"{what}: the flip rule reads {reading:.3f} > 1 (every head but "
             f"one within {TOL[kernel]:g}, that one within one flipped "
             f"probability more)")
    if not control > 1.0:
        fail(f"{what}: the control reads {control:.3f} on the flip rule, "
             f"within it: the check cannot tell that rounding apart")


def check_matvecs(params, cfg, gen, cases=None):
    """Phase 3: every quantized matvec of the 7B frame (``cases``, by
    default ``_matvec_cases``) against its plain version, with its
    control, timed beside one library call."""
    from moshi_tpu_torch.quant import matmul as mm
    from moshi_tpu_torch.quant import matmul_int8 as mi
    from moshi_tpu_torch.quant.formats import dequantize, int8_shape_ok
    rows = []
    for name, qt, layers, xdt, alpha, glu, calls, calls_unfused in \
            cases or _matvec_cases(params, cfg):
        k = qt.shape[-1]
        int8 = int8_shape_ok(qt, 1)
        kernel = "int8_matvec" if int8 else "dequant_matvec"
        o_full = qt.q.shape[-2]
        o = o_full // 2 if glu else o_full
        xs = [torch.randn((1, k), generator=gen, device=DEV).to(xdt)
              for _ in range(DRAWS)]
        qte = qt.with_eff_scales()

        def run_kernel(i, layer=None):
            lyr = (i % layers) if layer is None else layer
            x = xs[i % len(xs)]
            if int8:
                fn = mi.glu_matmul_i8 if glu else mi.qmatmul_i8
                return fn(x, qt, layer=lyr, alpha=alpha)
            return mm.dequant_matvec(x, qt, layer=lyr, alpha=alpha)

        def run_plain(i, layer=None, control=False):
            lyr = (i % layers) if layer is None else layer
            x = xs[i % len(xs)]
            a = None if alpha is None else alpha.reshape(-1, k)[lyr]
            if int8:
                fn = int8_control if control else mi.int8_matvec_plain
                return fn(x[0], qte, lyr, a, glu)
            if control:
                if a is not None:
                    raise ValueError("the K2 control takes no norm")
                return dequant_control(x, qte, lyr)[0]
            return mm.dequant_matvec_plain(x, qte, lyr, a)[0]

        max_err, max_rel, ctls = 0.0, 0.0, [0.0] * DRAWS
        for lyr in sorted({0, layers - 1}):
            for j in range(DRAWS):
                got = run_kernel(j, lyr).reshape(-1)
                ref = run_plain(j, lyr).reshape(-1)
                if not torch.isfinite(got).all():
                    fail(f"{name}: non-finite kernel output")
                max_err = max(max_err, float((got - ref).abs().max()))
                max_rel = max(max_rel, rel_err(got, ref))
                ctls[j] = max(ctls[j], rel_err(
                    run_plain(j, lyr, control=True).reshape(-1), ref))
        ctl = min(ctls)      # the draw on which the control shows least
        tol = TOL[kernel]
        check_limit(name, kernel, max_rel, ctl)
        t_kernel = time_ms(run_kernel, REPS)
        t_plain = time_ms(run_plain, max(REPS // 4, 3))
        # one library call for the same product: a bf16 GEMV on the weight
        # dequantized beforehand (the GLU's silu * value is left out)
        lib_layers = min(layers, 2)
        wd = dequantize(_first_layers(qt, lib_layers))   # [n, O, K] bf16

        def run_lib(i):
            return torch.matmul(xs[i % len(xs)].to(torch.bfloat16),
                                wd[i % lib_layers].T)

        t_lib = time_ms(run_lib, REPS)
        del wd
        nbytes = (_qt_layer_bytes(qt, o_full) + k * xs[0].element_size()
                  + (k * alpha.element_size() if alpha is not None else 0)
                  + o * 4)
        ops = 2.0 * o_full * k
        b_ms, b_by = bound_ms(nbytes, ops, "int8" if int8 else "bf16")
        # under the knobs K12 takes the temporal linear_out from K1
        knob_calls = 0 if (int8 and name == "temporal linear_out") else calls
        rows.append({
            "kernel": kernel, "shape": name, "fmt": qt.fmt, "O": o, "K": k,
            "glu": glu, "norm": alpha is not None, "calls_per_frame": calls,
            "calls_per_frame_unfused": calls_unfused,
            "calls_per_mxu_frame": knob_calls,
            "calls_per_split_frame": knob_calls,
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "control_rel_err": ctl, "tol_rel": tol,
            "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        })
        log(f"  {kernel:15s} {name:27s} {qt.fmt} O={o:5d} K={k:5d} "
            f"rel_err={max_rel:.2e} (tol {tol:g}, control {ctl:.2e})  "
            f"{t_kernel * 1e3:8.1f} us  bound {b_ms * 1e3:7.1f} us  plain "
            f"{t_plain * 1e3:9.1f} us  lib {t_lib * 1e3:8.1f} us  "
            f"x{calls}/frame (x{calls_unfused} unfused)  [{CARD}]")
    return rows


def attention_blocks(batch: int, m, chunk: int) -> int:
    """Blocks of one K3/K10 launch over ``batch`` sessions of the ring
    ``m`` (an MHA config) in chunks of ``chunk``."""
    from moshi_tpu_torch.nn.decode_attention import launch_plan
    return launch_plan(batch, m.num_heads, m.head_dim, m.cap, chunk).blocks


def k9_blocks(batch: int, m) -> int:
    """Blocks of one K9 launch over ``batch`` sessions of the ring ``m``
    (an MHA config): one per (session, head, chunk), the chunk min(256,
    cap), the last one cut at cap."""
    from moshi_tpu_torch.nn.decode_attention import chunk4_for, launch_plan
    return launch_plan(batch, m.num_heads, m.head_dim, m.cap,
                       chunk4_for(m.cap), ragged=True).blocks


def k13_blocks(tc, fp8: bool = False) -> int:
    """K13's cooperative grid on this card for the temporal stack ``tc``
    (0 on the CPU, where no kernel runs)."""
    if DEV != "cuda":
        return 0
    from moshi_tpu_torch.nn import temporal as tm
    return tm.grid_blocks(tc.dim, tc.hidden_dim, tc.mha.cap, fp8)


def check_attention(cfg, gen):
    """K3 at the temporal ring (full: every slot within the window) and
    the depformer ring at each of its steps, and K4 at the temporal
    rings."""
    from moshi_tpu_torch.nn import decode_attention as da
    from moshi_tpu_torch.nn import ring as rw
    rows = []
    bf = torch.bfloat16
    cases = []
    tcfg, dcfg = cfg.transformer, cfg.depformer
    for label, tc, offsets, calls in (
            ("temporal, full ring", tcfg, [tcfg.mha.cap + 7], tcfg.num_layers),
            ("temporal, path state (16 positions)", tcfg, [16], 0),
            ("depformer, steps 0-7", dcfg, list(range(cfg.dep_q)),
             dcfg.num_layers)):
        m = tc.mha
        shape = (tc.num_layers, 1, m.cap, m.num_heads, m.head_dim)
        k_ring = torch.randn(shape, generator=gen, device=DEV).to(bf)
        v_ring = torch.randn(shape, generator=gen, device=DEV).to(bf)
        # DRAWS triples (q, cur_k, cur_v)
        cur = [[torch.randn((1, m.num_heads, m.head_dim), generator=gen,
                            device=DEV).to(bf) for _ in range(3)]
               for _ in range(DRAWS)]
        cases.append((label, tc, m, k_ring, v_ring, cur, offsets, calls))
    tol = TOL["decode_attention"]
    for label, tc, m, k_ring, v_ring, cur, offsets, calls in cases:
        t_k = t_p = t_l = b_ms = nbytes = 0.0
        max_err = max_rel = rule = 0.0
        ctls, ctl_rule = [0.0] * DRAWS, [0.0] * DRAWS
        nl = tc.num_layers
        for off in offsets:
            offset = torch.tensor([off], dtype=torch.int32, device=DEV)

            def run_kernel(i, d=0):
                c = cur[d]
                return da.decode_attention_stacked(
                    c[0], k_ring, v_ring, c[1], c[2], offset, i % nl,
                    cap=m.cap, context=tc.context)

            def run_plain(i, d=0):
                c = cur[d]
                return da.decode_attention_plain(
                    c[0], k_ring[i % nl], v_ring[i % nl], c[1], c[2],
                    offset, cap=m.cap, context=tc.context,
                    chunk=da.chunk_for(m.cap))

            def run_lib(i):
                kk = k_ring[i % nl].transpose(1, 2)        # [B, H, cap, hd]
                vv = v_ring[i % nl].transpose(1, 2)
                return torch.nn.functional.scaled_dot_product_attention(
                    cur[0][0][:, :, None], kk, vv)

            for lyr in (0, nl - 1):
                for d in range(DRAWS):
                    got = run_kernel(lyr, d)
                    ref = run_plain(lyr, d)
                    bound = flip_bound(cur[d][0], k_ring[lyr], v_ring[lyr],
                                       offset, cap=m.cap, context=tc.context,
                                       cur_k=cur[d][1])
                    max_err = max(max_err, float((got - ref).abs().max()))
                    max_rel = max(max_rel, rel_err(got, ref))
                    rule = max(rule, flip_score(got, ref, bound, tol))
                    with swapped(da, "_bf16_round", lambda t: t):
                        ctl = run_plain(lyr, d)
                    ctls[d] = max(ctls[d], rel_err(ctl, ref))
                    ctl_rule[d] = max(ctl_rule[d],
                                      flip_score(ctl, ref, bound, tol))
            t_k += time_ms(run_kernel, REPS)
            t_p += time_ms(run_plain, max(REPS // 4, 3))
            t_l += time_ms(run_lib, REPS)
            last = off - 1
            valid = max(0, min(last + 1, tc.context - 1))
            row = m.num_heads * m.head_dim
            nb = valid * row * 2 * 2 + 3 * row * 2 + row * 4
            nbytes += nb
            b_ms += bound_ms(nb, 4.0 * (valid + 1) * row, "f32")[0]
        ctl = min(ctls)
        check_rule(f"decode attention ({label})", "decode_attention", rule,
                   min(ctl_rule))
        n = len(offsets)
        blocks = attention_blocks(1, m, da.chunk_for(m.cap))
        rows.append({
            "kernel": "decode_attention", "shape": label,
            "B": 1, "H": m.num_heads, "hd": m.head_dim, "cap": m.cap,
            "blocks_per_call": blocks,
            "offsets": offsets, "calls_per_frame": calls * n,
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "control_rel_err": ctl, "tol_rel": tol, "rule": rule,
            "control_rule": min(ctl_rule),
            # per call, averaged over the offsets
            "ms": t_k / n, "plain_ms": t_p / n, "library_ms": t_l / n,
            "bound_ms": b_ms / n, "bound_by": "bytes", "bytes": nbytes / n,
        })
        log(f"  decode_attention {label:38s} rel_err={max_rel:.2e}, rule "
            f"{rule:.3f} (tol {tol:g}; control {ctl:.2e}, rule "
            f"{min(ctl_rule):.3f})  {t_k / n * 1e3:8.1f} us  "
            f"bound {b_ms / n * 1e3:7.2f} us  plain {t_p / n * 1e3:9.1f} us"
            f"  sdpa {t_l / n * 1e3:7.1f} us  {blocks} blocks  [{CARD}]")

    # K4: the temporal ring write (one per frame)
    label, tc, m, k_ring, v_ring, cur, _, _ = cases[0]
    l, b = tc.num_layers, 1
    ks = torch.randn((l, b, m.num_heads, m.head_dim), generator=gen,
                     device=DEV).to(bf)
    vs = torch.randn_like(ks)
    slot = torch.tensor([123 % m.cap], dtype=torch.int32, device=DEV)
    kr, vr = k_ring.clone(), v_ring.clone()
    rw.ring_write_stacked(k_ring, v_ring, ks, vs, slot)
    rw.ring_write_plain(kr, vr, ks, vs, slot)
    sync()
    if not (torch.equal(k_ring, kr) and torch.equal(v_ring, vr)):
        fail("ring write: kernel and plain version disagree")
    slots = [torch.tensor([s], dtype=torch.int32, device=DEV)
             for s in (5, m.cap // 3, m.cap - 1)]

    def run_kernel(i):
        rw.ring_write_stacked(k_ring, v_ring, ks, vs, slots[i % 3])

    def run_plain(i):
        rw.ring_write_plain(k_ring, v_ring, ks, vs, slots[i % 3])

    def run_lib(i):
        idx = slots[i % 3].long()
        k_ring.index_copy_(2, idx, ks[:, :, None])
        v_ring.index_copy_(2, idx, vs[:, :, None])

    t_k = time_ms(run_kernel, REPS)
    t_p = time_ms(run_plain, REPS)
    t_l = time_ms(run_lib, REPS)
    nb = 4 * ks.numel() * ks.element_size()
    b_ms, _ = bound_ms(nb, 0.0, "f32")
    rows.append({
        "kernel": "ring_write", "shape": "temporal rings", "L": l, "B": b,
        "cap": m.cap, "calls_per_frame": 1, "calls_per_mxu_frame": 1,
        "calls_per_split_frame": 1, "max_abs_err": 0.0,
        "max_rel_err": 0.0, "tol_rel": 0.0, "ms": t_k, "plain_ms": t_p,
        "library_ms": t_l, "bound_ms": b_ms, "bound_by": "bytes",
        "bytes": nb})
    log(f"  ring_write      temporal rings {tuple(k_ring.shape)} exact  "
        f"{t_k * 1e3:8.1f} us  bound {b_ms * 1e3:6.2f} us  plain "
        f"{t_p * 1e3:8.1f} us  index_copy_ x2 {t_l * 1e3:7.1f} us  "
        f"[{CARD}]")
    return rows


def check_fused(params, cfg, gen):
    """K5 at the temporal shape (layers 0 and 31, f32 residual) and the
    depformer shape (flat rows 0 and 47, bf16 residual): g and h_mid
    against the plain version, the control on g."""
    from moshi_tpu_torch.quant import fused
    from moshi_tpu_torch.quant.formats import dequantize
    lay = params["transformer"]["layers"]
    dl = params["depformer"]["layers"]
    nd = cfg.dep_q * cfg.depformer_layers
    bf = torch.bfloat16
    rows = []
    for label, out_w, glu_w, alpha, layers, hdt in (
            ("temporal", lay["self_attn"]["out_proj"]["weight"],
             lay["gating"]["linear_in"]["weight"], lay["norm2"]["alpha"],
             cfg.num_layers, torch.float32),
            ("depformer", dl["self_attn"]["out_proj"]["weight"],
             dl["gating"]["linear_in"]["weight"],
             dl["norm2"]["alpha"].repeat(cfg.dep_q, 1), nd, bf)):
        k = out_w.shape[-1]
        h = glu_w.q.shape[-2] // 2
        draws = [(torch.randn((1, k), generator=gen, device=DEV).to(bf),
                  torch.randn((1, k), generator=gen, device=DEV).to(hdt))
                 for _ in range(DRAWS)]
        oe, ge = out_w.with_eff_scales(), glu_w.with_eff_scales()

        def run_kernel(i, layer=None):
            a, hc = draws[i % DRAWS]
            lyr = (i % layers) if layer is None else layer
            return fused.attn_ffn_fused_i8(a, hc, out_w, glu_w, alpha, lyr)

        def run_plain(i, layer=None, control=False):
            a, hc = draws[i % DRAWS]
            lyr = (i % layers) if layer is None else layer
            fn = fused_control if control else fused.attn_ffn_fused_plain
            return fn(a[0], hc[0], oe, ge, alpha.reshape(-1, k)[lyr], lyr)

        max_err, max_rel, ctls = 0.0, 0.0, [0.0] * DRAWS
        for lyr in sorted({0, layers - 1}):
            for j in range(DRAWS):
                g, hm = run_kernel(j, lyr)
                gp, hp = run_plain(j, lyr)
                if not (torch.isfinite(g).all() and torch.isfinite(hm).all()):
                    fail(f"attn_ffn_fused ({label}): non-finite output")
                for got, ref in ((g.reshape(-1), gp), (hm.reshape(-1), hp)):
                    max_err = max(max_err, float((got - ref).abs().max()))
                    max_rel = max(max_rel, rel_err(got, ref))
                ctls[j] = max(ctls[j], rel_err(
                    run_plain(j, lyr, control=True)[0], gp))
        ctl = min(ctls)
        tol = TOL["attn_ffn_fused"]
        check_limit(f"attn_ffn_fused ({label})", "attn_ffn_fused", max_rel,
                    ctl)
        t_kernel = time_ms(run_kernel, REPS)
        t_plain = time_ms(run_plain, max(REPS // 4, 3))
        # one library call per product: bf16 GEMVs on the out_proj and
        # linear_in weights dequantized beforehand
        wo = dequantize(_first_layers(out_w, 2))
        wg = dequantize(_first_layers(glu_w, 2))

        def run_lib(i):
            a, hc = draws[i % DRAWS]
            torch.matmul(a, wo[i % 2].T)
            torch.matmul(hc.to(bf), wg[i % 2].T)

        t_lib = time_ms(run_lib, REPS)
        del wo, wg
        a0, h0 = draws[0]
        nbytes = (_qt_layer_bytes(out_w, k) + _qt_layer_bytes(glu_w, 2 * h)
                  + k * a0.element_size() + k * h0.element_size()
                  + k * alpha.element_size() + h * 4 + k * 4)
        b_ms, b_by = bound_ms(nbytes, 2.0 * k * (k + 2 * h), "int8")
        rows.append({
            "kernel": "attn_ffn_fused", "shape": label, "fmt": out_w.fmt,
            "K": k, "H": h, "calls_per_frame": layers,
            "calls_per_frame_unfused": 0, "calls_per_mxu_frame": layers,
            "calls_per_split_frame": layers,
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "control_rel_err": ctl, "tol_rel": tol,
            "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        })
        log(f"  attn_ffn_fused  {label:27s} {out_w.fmt} K={k:5d} H={h:5d} "
            f"rel_err={max_rel:.2e} (tol {tol:g}, control {ctl:.2e})  "
            f"{t_kernel * 1e3:8.1f} us  bound {b_ms * 1e3:7.1f} us  plain "
            f"{t_plain * 1e3:9.1f} us  lib {t_lib * 1e3:8.1f} us  "
            f"x{layers}/frame  [{CARD}]")
    return rows


def dequant_act_f32(x, qt, layer, alpha=None):
    """The dequant kernels' product (K2, K6, K8) with the activation left
    in f32 (the kernels round it to bf16): one rounding changed."""
    from moshi_tpu_torch.quant import matmul as mm
    from moshi_tpu_torch.quant.formats import QK, rms_pre_norm
    xn = x.float() if alpha is None else rms_pre_norm(x, alpha)
    y = xn @ mm.dequantized_f32(qt, layer).T
    if qt.fmt == "q4_k":
        em = mm.layer_rows(qt.em, qt.q.shape[-2], layer).float()
        y = y - xn.reshape(xn.shape[0], -1, QK).sum(-1) @ em.T
    return y


def dequant_w_f32(x, qt, layer, alpha=None):
    """The dequant kernels' product (K2, K6) with each weight element left
    in f32 (the kernels round it to bf16): one rounding changed."""
    from moshi_tpu_torch.quant import matmul as mm
    from moshi_tpu_torch.quant.formats import QK, _unpack_nibbles, \
        rms_pre_norm
    rows = qt.q.shape[-2]
    q = mm.layer_rows(qt.q, rows, layer)
    if qt.fmt == "q8_0":
        w, s = q.float(), qt.d
    elif qt.fmt == "q4_0":
        w, s = _unpack_nibbles(q).float() - 8.0, qt.d
    else:
        w, s = _unpack_nibbles(q).float(), qt.es
    w = w * torch.repeat_interleave(mm.layer_rows(s, rows, layer).float(),
                                    QK, dim=-1)
    xn = x.float() if alpha is None else rms_pre_norm(x, alpha)
    y = _bf16_round(xn) @ w.T
    if qt.fmt == "q4_k":
        em = mm.layer_rows(qt.em, rows, layer).float()
        y = y - xn.reshape(xn.shape[0], -1, QK).sum(-1) @ em.T
    return y


def glu_gate_bf16(x, qt, layer, alpha=None):
    """K8's plain version with the gate rounded to bf16 before the silu."""
    from moshi_tpu_torch.quant import matmul as mm
    gv = mm.dequant_matvec_plain(x, qt, layer, alpha)
    h = gv.shape[-1] // 2
    return mm._silu(_bf16_round(gv[:, :h])) * gv[:, h:]


def staged_activations(x, alpha):
    """The bf16 activations (as f32) that the dequant kernels stage for
    the rows ``x`` with the rms pre-norm ``alpha`` fused, read back
    exactly: K6 on a flat q8_0 identity [K, K], each output one staged
    element times 1.  K6, K7 and K8 stage through one code
    (``dequant_tile.cuh`` ``stage``), whose norm is the same for every
    format and row group."""
    from moshi_tpu_torch.quant import matmul as mm
    from moshi_tpu_torch.quant.formats import QK, QuantTensor
    k = x.shape[-1]
    eye = QuantTensor("q8_0", (k, k),
                      q=torch.eye(k, dtype=torch.int8, device=x.device),
                      d=torch.ones((k, k // QK), dtype=torch.bfloat16,
                                   device=x.device))
    return mm.qmatmul_dequant(x, eye, alpha=alpha)


def glu_on(xb, xn, qt, layer, gate_bf16=False):
    """K8's plain version on given bf16 activations ``xb`` (as f32), with
    the q4_k block sums of the f32 activations ``xn``; with ``gate_bf16``
    the gate rounded to bf16 before the silu (the control)."""
    from moshi_tpu_torch.quant import matmul as mm
    from moshi_tpu_torch.quant.formats import QK
    gv = xb @ mm.dequantize_layer_bf16(qt, layer).float().T
    if qt.fmt == "q4_k":
        em = mm.layer_rows(qt.em, qt.q.shape[-2], layer).float()
        gv = gv - xn.reshape(xn.shape[0], -1, QK).sum(-1) @ em.T
    h = gv.shape[-1] // 2
    g = _bf16_round(gv[:, :h]) if gate_bf16 else gv[:, :h]
    return mm._silu(g) * gv[:, h:]


def norm_flips(xb, xn):
    """Where the staged bf16 activations ``xb`` differ from the bf16
    rounding of the plain norm's f32 ``xn``: (their count, whether each is
    the other bf16 neighbour of xn, the largest distance of xn from the
    rounding boundary between the two, relative to |xn|)."""
    pb = _bf16_round(xn)
    f = xb != pb
    if not bool(f.any()):
        return 0, True, 0.0
    bits = [t[f].to(torch.bfloat16).view(torch.int16).int() for t in (xb, pb)]
    adjacent = bool(((bits[0] - bits[1]).abs() == 1).all())
    mid = (xb[f] + pb[f]) / 2          # exact: two bf16 neighbours
    tie = float(((xn[f] - mid).abs() / xn[f].abs()).max())
    return int(f.sum()), adjacent, tie


class GluNorm:
    """K7's and K8's readings with the rms pre-norm fused, held on the
    kernel's own staged activations (``TOL``'s glu_norm note): the error
    against the plain version on those activations, its control (the
    gate rounded to bf16), and the activations that differ from the plain
    norm's, each of which must be a tie."""

    def __init__(self):
        self.rel, self.ctls, self.flips = 0.0, [0.0] * DRAWS, 0
        self.adjacent, self.tie = True, 0.0

    def add(self, got, x, qt, layer, alpha, draw):
        from moshi_tpu_torch.quant.formats import rms_pre_norm
        xn = rms_pre_norm(x, alpha)
        xb = staged_activations(x, alpha)
        ref = glu_on(xb, xn, qt, layer)
        self.rel = max(self.rel, rel_err(got, ref))
        self.ctls[draw] = max(self.ctls[draw], rel_err(
            glu_on(xb, xn, qt, layer, gate_bf16=True), ref))
        n, adjacent, tie = norm_flips(xb, xn)
        self.flips += n
        self.adjacent = self.adjacent and adjacent
        self.tie = max(self.tie, tie)

    def hold(self, what):
        check_limit(f"{what} on its staged activations", "glu_matvec",
                    self.rel, min(self.ctls))
        if not self.adjacent:
            fail(f"{what}: a staged activation is not a bf16 neighbour of "
                 f"the plain norm's value")
        if not self.tie <= TOL["norm_tie"]:
            fail(f"{what}: a staged activation differs from the plain "
                 f"norm's rounding {self.tie:.3e} from the boundary > "
                 f"{TOL['norm_tie']:g}")

    def fields(self, plain_rel, plain_ctl):
        """A check row's reading fields, given the reading and control
        against the plain version with its own norm (logged, not held)."""
        return {"max_rel_err": self.rel, "control_rel_err": min(self.ctls),
                "tol_rel": TOL["glu_matvec"], "norm_flips": self.flips,
                "norm_tie": self.tie, "plain_norm_rel_err": plain_rel,
                "plain_norm_control_rel_err": plain_ctl}

    def text(self, plain_rel, plain_ctl):
        return (f"rel_err={plain_rel:.2e} against the plain norm (control "
                f"{plain_ctl:.2e}); on its staged activations "
                f"{self.rel:.2e} (tol {TOL['glu_matvec']:g}, control "
                f"{min(self.ctls):.2e}), {self.flips} at a tie "
                f"({self.tie:.1e})")


def held_reading(what, kernel, staged, rel, ctl):
    """Hold a dequant check row (``staged``, a GluNorm, for K7 and K8 with
    the norm fused; else the reading ``rel`` and control ``ctl`` against
    the limit ``kernel``): its reading fields and its log text."""
    if staged:
        staged.hold(what)
        return staged.fields(rel, ctl), staged.text(rel, ctl)
    check_limit(what, kernel, rel, ctl)
    return ({"max_rel_err": rel, "control_rel_err": ctl,
             "tol_rel": TOL[kernel]},
            f"rel_err={rel:.2e} (tol {TOL[kernel]:g}, control {ctl:.2e})")


def pool_matvec_cases(params, cfg):
    """(name, kernel, weight, layers, x dtype, norm alpha, calls per tick)
    for every quantized product of a frame at B > 1, where nothing takes
    the int8 kernels: the flat products (text head, depformer
    in-projection) take K6, the GLUs K8 (q4_0 ones the two-call form on
    K2), everything else K2."""
    from moshi_tpu_torch.quant.formats import flatten_lead
    from moshi_tpu_torch.quant.matmul import GLU_FORMATS
    lay = params["transformer"]["layers"]
    dep = params["depformer"]
    dl = dep["layers"]
    nl, dnl, dq = cfg.num_layers, cfg.depformer_layers, cfg.dep_q
    n1t = dl["norm1"]["alpha"].repeat(dq, 1)
    n2t = dl["norm2"]["alpha"].repeat(dq, 1)
    f32, bf = torch.float32, torch.bfloat16

    def glu(w):
        return "glu_matvec" if w.fmt in GLU_FORMATS else "dequant_matvec"

    t_glu = lay["gating"]["linear_in"]["weight"]
    d_glu = dl["gating"]["linear_in"]["weight"]
    return [
        ("temporal in_proj", "dequant_matvec",
         lay["self_attn"]["in_proj"]["weight"], nl, f32,
         lay["norm1"]["alpha"], nl),
        ("temporal out_proj", "dequant_matvec",
         lay["self_attn"]["out_proj"]["weight"], nl, bf, None, nl),
        ("temporal linear_in (GLU)", glu(t_glu), t_glu, nl, f32,
         lay["norm2"]["alpha"], nl),
        ("temporal linear_out", "dequant_matvec",
         lay["gating"]["linear_out"]["weight"], nl, bf, None, nl),
        ("text head", "qmatmul", params["text_linear"]["weight"], 1, f32,
         None, 1),
        ("depformer in", "qmatmul", flatten_lead(dep["in"]["weight"]), 1,
         bf, None, 1),
        ("depformer in_proj", "dequant_matvec",
         dl["self_attn"]["in_proj"]["weight"], dq * dnl, bf, n1t, dq * dnl),
        ("depformer out_proj", "dequant_matvec",
         dl["self_attn"]["out_proj"]["weight"], dq * dnl, bf, None,
         dq * dnl),
        ("depformer linear_in (GLU)", glu(d_glu), d_glu, dq * dnl, bf, n2t,
         dq * dnl),
        ("depformer linear_out", "dequant_matvec",
         dl["gating"]["linear_out"]["weight"], dq * dnl, bf, None,
         dq * dnl),
        ("depformer logits", "dequant_matvec", dep["linears"]["weight"], dq,
         bf, None, dq),
    ]


def check_pool_matvecs(params, cfg, gen, batch: int, cases=None,
                       calls_key: str = "calls_per_tick"):
    """Phase 3 at B = ``batch``: every product of the batched frame on its
    kernel against the plain version at m = ``batch`` (K6 and K8 also at
    m = POOL_M_EXTRA, a second row group), each limit held against a
    control: the weight elements left in f32 (K2, K6) or the gate rounded
    to bf16 before the silu (K8).  Timed at m = ``batch`` beside the plain
    version, one library call (bf16 torch.matmul on the weight dequantized
    beforehand; for K8, then silu(gate) * value) and the bound.  ``cases``
    (default ``pool_matvec_cases``) and the row key of their calls per
    frame (``calls_key``: "calls_per_tts_tick" for the TTS pool's) may be
    given."""
    from moshi_tpu_torch.quant import matmul as mm
    from moshi_tpu_torch.quant.formats import dequantize
    rows = []
    pool = "" if calls_key == "calls_per_tick" else "TTS "
    for name, kernel, qt, layers, xdt, alpha, calls in \
            (cases or pool_matvec_cases(params, cfg)):
        k = qt.shape[-1]
        o_full = qt.q.shape[-2]
        glu = kernel == "glu_matvec"
        o = o_full // 2 if glu else o_full
        qte = qt.with_eff_scales()
        ms = [batch] + ([POOL_M_EXTRA] if kernel != "dequant_matvec" else [])
        xs = {m: [torch.randn((m, k), generator=gen, device=DEV).to(xdt)
                  for _ in range(DRAWS)] for m in ms}

        def run_kernel(i, layer=None, m=batch):
            lyr = (i % layers) if layer is None else layer
            x = xs[m][i % DRAWS]
            if kernel == "qmatmul":
                return mm.qmatmul_dequant(x, qt, alpha=alpha)
            if glu:
                return mm.glu_matvec(x, qt, layer=lyr, alpha=alpha)
            return mm.dequant_matvec(x, qt, layer=lyr, alpha=alpha)

        def run_plain(i, layer=None, m=batch, control=False):
            lyr = (i % layers) if layer is None else layer
            x = xs[m][i % DRAWS]
            a = None if alpha is None else alpha.reshape(-1, k)[lyr]
            if control:
                return (glu_gate_bf16 if glu else dequant_w_f32)(
                    x, qte, lyr, a)
            if kernel == "qmatmul":
                return mm.qmatmul_plain(x, qte, a)
            if glu:
                return mm.glu_matvec_plain(x, qte, lyr, a)
            return mm.dequant_matvec_plain(x, qte, lyr, a)

        max_err, max_rel, ctls = 0.0, 0.0, [0.0] * DRAWS
        staged = GluNorm() if glu and alpha is not None else None
        for m in ms:
            for lyr in sorted({0, layers - 1}):
                for j in range(DRAWS):
                    got = run_kernel(j, lyr, m)
                    ref = run_plain(j, lyr, m)
                    if got.shape != (m, o) or not torch.isfinite(got).all():
                        fail(f"{pool}B={batch} {name}: kernel output "
                             f"{tuple(got.shape)} or non-finite")
                    max_err = max(max_err, float((got - ref).abs().max()))
                    max_rel = max(max_rel, rel_err(got, ref))
                    ctls[j] = max(ctls[j], rel_err(
                        run_plain(j, lyr, m, control=True), ref))
                    if staged:
                        staged.add(got, xs[m][j], qte, lyr,
                                   alpha.reshape(-1, k)[lyr], j)
        ctl = min(ctls)
        held, reading = held_reading(
            f"{pool}B={batch} {name} ({kernel})",
            kernel if alpha is None else "dequant_norm", staged, max_rel,
            ctl)
        t_kernel = time_ms(run_kernel, REPS)
        t_plain = time_ms(run_plain, max(REPS // 4, 3))
        lib_layers = min(layers, 2)
        wd = dequantize(_first_layers(qt, lib_layers))    # [n, O, K] bf16

        def run_lib(i):
            y = torch.matmul(xs[batch][i % DRAWS].to(torch.bfloat16),
                             wd[i % lib_layers].T)
            if glu:
                gate, value = y.float().chunk(2, dim=-1)
                y = torch.nn.functional.silu(gate) * value
            return y

        t_lib = time_ms(run_lib, REPS)
        del wd
        xb = xs[batch][0].element_size()
        nbytes = (_qt_layer_bytes(qt, o_full) + batch * k * xb
                  + (k * alpha.element_size() if alpha is not None else 0)
                  + batch * o * 4)
        b_ms, b_by = bound_ms(nbytes, 2.0 * batch * o_full * k, "bf16")
        rows.append({
            "kernel": kernel, "shape": name, "fmt": qt.fmt, "B": batch,
            "m_checked": ms, "O": o, "K": k, "glu": glu,
            "norm": alpha is not None, "calls_per_frame": 0,
            "calls_per_tick": 0, calls_key: calls, "max_abs_err": max_err,
            **held, "ms": t_kernel, "plain_ms": t_plain,
            "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes,
        })
        log(f"  {kernel:15s} {pool}B={batch} {name:27s} {qt.fmt} O={o:5d} "
            f"K={k:5d} m {ms} {reading}  "
            f"{t_kernel * 1e3:8.1f} us  bound "
            f"{b_ms * 1e3:7.1f} us  plain {t_plain * 1e3:9.1f} us  lib "
            f"{t_lib * 1e3:8.1f} us  x{calls}/{pool}tick  [{CARD}]")
    return rows


def tts_pool_matvec_cases(params, cfg):
    """(name, kernel, weight, layers, x dtype, norm alpha, calls per tick)
    for the K2, K6 and K8 products of a ``TTSSessionPool`` tick at B > 1:
    per temporal layer (the generic layer path: a flat layer of the
    stacked weight, f32 activations) the in_proj (norm1 fused), out_proj
    and linear_out on K6, and the text head and the depformer
    in-projection; per depformer step and layer the in_proj (norm1 fused),
    out_proj and linear_out on K2 and the GLU (norm2 fused) on K8, and
    each step's logits (``tts_pool_launches``).  The temporal GLU takes
    K7 (``check_k7``)."""
    from moshi_tpu_torch.quant.formats import flatten_lead
    lay = params["transformer"]["layers"]
    dep = params["depformer"]
    dl = dep["layers"]
    nl = cfg.num_layers
    d = cfg.depformer_layers * cfg.runtime_dep_q
    f32, bf = torch.float32, torch.bfloat16

    def first(name):          # a temporal layer as a flat [O, K] weight
        return lay[name[0]][name[1]]["weight"]._map(lambda a: a[0])

    return [
        ("temporal in_proj", "qmatmul", first(("self_attn", "in_proj")), 1,
         f32, lay["norm1"]["alpha"][0], nl),
        ("temporal out_proj", "qmatmul", first(("self_attn", "out_proj")),
         1, f32, None, nl),
        ("temporal linear_out", "qmatmul",
         first(("gating", "linear_out")), 1, f32, None, nl),
        ("text head", "qmatmul", params["text_linear"]["weight"], 1, f32,
         None, 1),
        ("depformer in", "qmatmul", flatten_lead(dep["in"]["weight"]), 1,
         bf, None, 1),
        ("depformer in_proj", "dequant_matvec",
         dl["self_attn"]["in_proj"]["weight"], d, bf,
         dl["norm1"]["alpha"].repeat(cfg.runtime_dep_q, 1), d),
        ("depformer out_proj", "dequant_matvec",
         dl["self_attn"]["out_proj"]["weight"], d, bf, None, d),
        ("depformer linear_out", "dequant_matvec",
         dl["gating"]["linear_out"]["weight"], d, bf, None, d),
        ("depformer logits", "dequant_matvec", dep["linears"]["weight"],
         cfg.runtime_dep_q, bf, None, cfg.runtime_dep_q),
        ("depformer linear_in (GLU)", "glu_matvec",
         dl["gating"]["linear_in"]["weight"], d, bf,
         dl["norm2"]["alpha"].repeat(cfg.runtime_dep_q, 1), d),
    ]


def check_tts_pool_matvecs(params, cfg, batch: int):
    """Phase 3 (tts_pool): ``check_pool_matvecs`` over
    ``tts_pool_matvec_cases`` at B = ``batch``, K6's and K2's products on
    one generator and K8's on one of its own, so that adding K8 moved no
    earlier draw."""
    cases = tts_pool_matvec_cases(params, cfg)
    rows = []
    for kernels, seed in ((("qmatmul", "dequant_matvec"), SEED + 25),
                          (("glu_matvec",), SEED + 26)):
        rows += check_pool_matvecs(
            params, cfg, torch.Generator(device=DEV).manual_seed(seed),
            batch, cases=[c for c in cases if c[1] in kernels],
            calls_key="calls_per_tts_tick")
    return rows


PROBE_K = 1024      # the dequantization probe's K (and rows: one-hot)
PROBE_FULL = True   # every scale (False: every exponent, a few mantissas)
# the largest |value| a block's scale multiplies, by format
_PROBE_MAX = {"q4_k": 15.0, "q4_0": 8.0, "q8_0": 128.0}


def probe_scale_bits(fmt: str, full: bool = True) -> torch.Tensor:
    """bf16 bit patterns (int16) of the probe's scales: every bf16 value
    whose largest product with the format's values rounds to a finite
    bf16, both signs, the zeros and the subnormals among them; or, with
    ``full`` off, those of every exponent with the mantissas 0, 1, 0x55
    and 0x7f."""
    import numpy as np
    if full:
        bits = np.arange(1 << 16)
    else:
        pos = ((np.arange(256)[:, None] << 7)
               | np.array([0, 1, 0x55, 0x7f])[None, :]).reshape(-1)
        bits = np.concatenate([pos, pos | 0x8000])
    b = torch.from_numpy(bits.astype(np.uint16).view(np.int16))
    top = (b.view(torch.bfloat16).float() * _PROBE_MAX[fmt]).to(
        torch.bfloat16)
    return b[torch.isfinite(top.float())]


def probe_weight(fmt: str, bits: torch.Tensor, k: int, layers: int = 1):
    """A QuantTensor [O, k] on the CPU (stacked [layers, O, k] if
    ``layers`` > 1, the probe in the last layer and its scales reversed in
    the others) whose 32-blocks carry the scales ``bits`` in order, each
    with every value of its format: a 4-bit block holds the 16 nibbles
    twice, and q8_0 gives each scale eight blocks that hold the 256 int8
    values; the last row's spare blocks take scale +0, q4_k's mins are
    +0."""
    from moshi_tpu_torch.quant.formats import QK, QuantTensor
    nb = k // QK
    per = 8 if fmt == "q8_0" else 1
    scales = bits.repeat_interleave(per)
    o = -(-scales.numel() // nb)
    flat = torch.zeros(o * nb, dtype=torch.int16)
    flat[:scales.numel()] = scales
    if fmt == "q8_0":
        q = ((torch.arange(o * k) % 256) - 128).to(torch.int8).reshape(o, k)
    else:
        q = ((torch.arange(k // 2) % 16) * 17).to(torch.uint8).expand(
            o, -1).contiguous()
    s = [flat.flip(0)] * (layers - 1) + [flat]
    s = torch.stack(s).view(torch.bfloat16).reshape(layers, o, nb)
    q = torch.stack([q] * layers)
    if layers == 1:
        s, q = s[0], q[0]
    if fmt != "q4_k":
        return QuantTensor(fmt, (o, k), q=q, d=s)
    return QuantTensor(fmt, (o, k), q=q, d=s, es=s, em=torch.zeros_like(s))


def check_dequant_probe():
    """Phase 3: every dequantization K6 and K2 perform, exactly.  One-hot
    activation rows (the identity, m = PROBE_K) through K6 on a flat
    ``probe_weight`` and through K2 on layer 1 of a 2-layer stacked one:
    each output must equal the weight element as
    ``dequantize_layer_bf16`` forms it on the CPU (equal as values: the
    kernels' sums start at +0, so a -0 element reads +0)."""
    from moshi_tpu_torch.quant import matmul as mm
    k = PROBE_K
    x = torch.eye(k, device=DEV)
    report = {}
    for fmt in ("q4_k", "q4_0", "q8_0"):
        bits = probe_scale_bits(fmt, PROBE_FULL)
        out = {"scales": int(bits.numel())}
        for kernel, layers in (("qmatmul", 1), ("dequant_matvec", 2)):
            qt = probe_weight(fmt, bits, k, layers)
            ref = mm.dequantize_layer_bf16(qt, layers - 1).float().T
            qd = qt.to(DEV)
            got = (mm.qmatmul_dequant(x, qd) if layers == 1
                   else mm.dequant_matvec(x, qd, layer=layers - 1)).cpu()
            if got.shape != ref.shape:
                fail(f"dequant probe {fmt} {kernel}: output "
                     f"{tuple(got.shape)}, expected {tuple(ref.shape)}")
            differ = int((got != ref).sum())
            if differ:
                fail(f"dequant probe {fmt} {kernel}: {differ} of "
                     f"{ref.numel()} outputs differ from "
                     f"dequantize_layer_bf16")
            out[kernel] = {"rows": qt.q.shape[-2], "exact": ref.numel()}
        report[fmt] = out
        log(f"  dequant probe {fmt}: {out['scales']} scales, one-hot m = "
            f"{k}: K6 {out['qmatmul']['exact']} and K2 (layer 1 of 2) "
            f"{out['dequant_matvec']['exact']} outputs equal to "
            f"dequantize_layer_bf16")
    return report


def pool_offsets(cap: int, batch: int):
    """``batch`` different session ages: young ones, a partly filled ring,
    one at the end of its first ring, and wrapped ones (the last past its
    second ring)."""
    base = [3, 40, cap // 12, cap // 3, (3 * cap) // 4, cap - 1, cap + 17,
            2 * cap + 411]
    return [base[i % len(base)] + cap * (i // len(base))
            for i in range(batch)]


def check_pool_attention(cfg, gen, batch: int):
    """Phase 3 at B = ``batch``: K3 over the temporal ring with every
    session at another age (``pool_offsets``: some wrapped), and over the
    depformer ring at each step, against the plain version (control: p
    in f32); K4 writing every session's slot at once, bit-exact.  The
    rings hold two layers (the kernels index the layer; the per-layer
    shapes are the frame's)."""
    from moshi_tpu_torch.nn import decode_attention as da
    from moshi_tpu_torch.nn import ring as rw
    bf = torch.bfloat16
    rows = []
    tcfg, dcfg = cfg.transformer, cfg.depformer
    cases = [("temporal, 8 ages", tcfg,
              [pool_offsets(tcfg.mha.cap, batch)], tcfg.num_layers),
             ("depformer, steps 0-7", dcfg,
              [[cb] * batch for cb in range(cfg.dep_q)], dcfg.num_layers)]
    for label, tc, offset_sets, calls in cases:
        m = tc.mha
        shape = (2, batch, m.cap, m.num_heads, m.head_dim)
        k_ring = torch.randn(shape, generator=gen, device=DEV).to(bf)
        v_ring = torch.randn(shape, generator=gen, device=DEV).to(bf)
        cur = [[torch.randn((batch, m.num_heads, m.head_dim), generator=gen,
                            device=DEV).to(bf) for _ in range(3)]
               for _ in range(DRAWS)]
        t_k = t_p = t_l = b_ms = nbytes = 0.0
        max_err = max_rel = rule = 0.0
        ctls, ctl_rule = [0.0] * DRAWS, [0.0] * DRAWS
        tol = TOL["decode_attention"]
        for offs in offset_sets:
            offset = torch.tensor(offs, dtype=torch.int32, device=DEV)

            def run_kernel(i, d=0):
                c = cur[d]
                return da.decode_attention_stacked(
                    c[0], k_ring, v_ring, c[1], c[2], offset, i % 2,
                    cap=m.cap, context=tc.context)

            def run_plain(i, d=0):
                c = cur[d]
                return da.decode_attention_plain(
                    c[0], k_ring[i % 2], v_ring[i % 2], c[1], c[2], offset,
                    cap=m.cap, context=tc.context,
                    chunk=da.chunk_for(m.cap))

            def run_lib(i):
                kk = k_ring[i % 2].transpose(1, 2)         # [B, H, cap, hd]
                vv = v_ring[i % 2].transpose(1, 2)
                return torch.nn.functional.scaled_dot_product_attention(
                    cur[0][0][:, :, None], kk, vv)

            for lyr in (0, 1):
                for d in range(DRAWS):
                    got = run_kernel(lyr, d)
                    ref = run_plain(lyr, d)
                    bound = flip_bound(cur[d][0], k_ring[lyr], v_ring[lyr],
                                       offset, cap=m.cap, context=tc.context,
                                       cur_k=cur[d][1])
                    max_err = max(max_err, float((got - ref).abs().max()))
                    max_rel = max(max_rel, rel_err(got, ref))
                    rule = max(rule, flip_score(got, ref, bound, tol))
                    with swapped(da, "_bf16_round", lambda t: t):
                        ctl = run_plain(lyr, d)
                    ctls[d] = max(ctls[d], rel_err(ctl, ref))
                    ctl_rule[d] = max(ctl_rule[d],
                                      flip_score(ctl, ref, bound, tol))
            t_k += time_ms(run_kernel, REPS)
            t_p += time_ms(run_plain, max(REPS // 4, 3))
            t_l += time_ms(run_lib, REPS)
            row = m.num_heads * m.head_dim
            valid = sum(max(0, min(off, tc.context - 1)) for off in offs)
            nb = valid * row * 2 * 2 + batch * (3 * row * 2 + row * 4)
            nbytes += nb
            b_ms += bound_ms(nb, 4.0 * (valid + batch) * row, "f32")[0]
        ctl = min(ctls)
        check_rule(f"decode attention B={batch} ({label})",
                   "decode_attention", rule, min(ctl_rule))
        n = len(offset_sets)
        blocks = attention_blocks(batch, m, da.chunk_for(m.cap))
        rows.append({
            "kernel": "decode_attention", "shape": f"B={batch} {label}",
            "B": batch, "H": m.num_heads, "hd": m.head_dim, "cap": m.cap,
            "blocks_per_call": blocks, "offsets": offset_sets, "calls_per_frame": 0,
            "calls_per_tick": calls * n, "max_abs_err": max_err,
            "max_rel_err": max_rel, "control_rel_err": ctl,
            "tol_rel": tol, "rule": rule, "control_rule": min(ctl_rule),
            "ms": t_k / n,
            "plain_ms": t_p / n, "library_ms": t_l / n,
            "bound_ms": b_ms / n, "bound_by": "bytes", "bytes": nbytes / n})
        log(f"  decode_attention B={batch} {label:22s} rel_err={max_rel:.2e}"
            f", rule {rule:.3f} (tol {tol:g}; control {ctl:.2e}, rule "
            f"{min(ctl_rule):.3f})  "
            f"{t_k / n * 1e3:8.1f} us  bound {b_ms / n * 1e3:7.2f} us  plain "
            f"{t_p / n * 1e3:9.1f} us  sdpa {t_l / n * 1e3:7.1f} us  "
            f"{blocks} blocks  [{CARD}]")

    # K4: every session's slot of the temporal rings at once
    m = tcfg.mha
    shape = (2, batch, m.cap, m.num_heads, m.head_dim)
    k_ring = torch.randn(shape, generator=gen, device=DEV).to(bf)
    v_ring = torch.randn(shape, generator=gen, device=DEV).to(bf)
    ks = torch.randn((2, batch, m.num_heads, m.head_dim), generator=gen,
                     device=DEV).to(bf)
    vs = torch.randn_like(ks)
    slot = torch.tensor([o % m.cap for o in pool_offsets(m.cap, batch)],
                        dtype=torch.int32, device=DEV)
    kr, vr = k_ring.clone(), v_ring.clone()
    rw.ring_write_stacked(k_ring, v_ring, ks, vs, slot)
    rw.ring_write_plain(kr, vr, ks, vs, slot)
    sync()
    if not (torch.equal(k_ring, kr) and torch.equal(v_ring, vr)):
        fail(f"ring write B={batch}: kernel and plain version disagree")
    t_k = time_ms(lambda i: rw.ring_write_stacked(k_ring, v_ring, ks, vs,
                                                  slot), REPS)
    nb = 4 * ks.numel() * ks.element_size()
    rows.append({
        "kernel": "ring_write", "shape": f"B={batch} temporal rings",
        "L": 2, "B": batch, "cap": m.cap, "slots": slot.tolist(),
        "calls_per_frame": 0, "calls_per_tick": 1, "max_abs_err": 0.0,
        "max_rel_err": 0.0, "tol_rel": 0.0, "ms": t_k,
        "bound_ms": bound_ms(nb, 0.0, "f32")[0], "bound_by": "bytes",
        "bytes": nb})
    log(f"  ring_write      B={batch} temporal rings (2 layers), slots "
        f"{slot.tolist()}: exact  {t_k * 1e3:8.1f} us  [{CARD}]")
    return rows


# ---------------------------------------------------------------------------
# phase 3 (TTS): K1 at m <= 8 rows, K7, and K9 / K11 at B = POOL_B
# ---------------------------------------------------------------------------

def tts_config(num_layers: int = 0):
    """The cross-attention TTS class (``runtime/synth.py``
    ``tts_class_config``: ``configs/bench/tts-default-class.json`` with
    cross_attention on), with ``num_layers`` temporal layers if given."""
    from moshi_tpu_torch.runtime.synth import tts_class_config
    return tts_class_config(num_layers)[1]


def _tts_products(params, cfg):
    """(name, weight, layers, norm alpha, glu) of the TTS class's temporal
    products and its text head, f32 activations as the generic layer path
    gives them: the self-attention in_proj (norm1 fused) and out_proj, the
    cross-attention's queries (the whole fused in_proj) and out_proj, the
    GLU (norm2 fused), linear_out."""
    lay = params["transformer"]["layers"]
    nl = cfg.num_layers
    return [
        ("temporal in_proj", lay["self_attn"]["in_proj"]["weight"], nl,
         lay["norm1"]["alpha"], False),
        ("temporal out_proj", lay["self_attn"]["out_proj"]["weight"], nl,
         None, False),
        ("cross in_proj (q)", lay["cross_attention"]["in_proj"]["weight"],
         nl, None, False),
        ("cross out_proj", lay["cross_attention"]["out_proj"]["weight"], nl,
         None, False),
        ("temporal linear_in (GLU)", lay["gating"]["linear_in"]["weight"],
         nl, lay["norm2"]["alpha"], True),
        ("temporal linear_out", lay["gating"]["linear_out"]["weight"], nl,
         None, False),
        ("text head", params["text_linear"]["weight"], 1, None, False),
    ]


def check_k1_rows(params, cfg, gen):
    """Phase 3: K1 at TTS_ROWS rows (the rows MOSHI_TPU_INT8_MAX_M > 1
    sends it) on the TTS class's products, against the plain version
    (limit int8_matvec; control: each block's scaled partial rounded to
    bf16), timed at the largest row count beside the plain version, one
    library call and the bound.  Each of its rows must equal K1 on that
    row alone bit for bit (each row's sums take the one-row kernel's
    order)."""
    from moshi_tpu_torch.quant import matmul_int8 as mi
    from moshi_tpu_torch.quant.formats import dequantize
    rows = []
    for name, qt, layers, alpha, glu in _tts_products(params, cfg):
        k = qt.shape[-1]
        o_full = qt.q.shape[-2]
        o = o_full // 2 if glu else o_full
        qte = qt.with_eff_scales()
        xs = {m: [torch.randn((m, k), generator=gen, device=DEV)
                  for _ in range(DRAWS)] for m in TTS_ROWS}
        fn = mi.glu_matmul_i8 if glu else mi.qmatmul_i8

        def run_kernel(i, layer=None, m=TTS_ROWS[-1]):
            lyr = (i % layers) if layer is None else layer
            return fn(xs[m][i % DRAWS], qt, layer=lyr, alpha=alpha)

        def run_plain(i, layer=None, m=TTS_ROWS[-1], control=False):
            lyr = (i % layers) if layer is None else layer
            a = None if alpha is None else alpha.reshape(-1, k)[lyr]
            plain = int8_control if control else mi.int8_matvec_plain
            return plain(xs[m][i % DRAWS], qte, lyr, a, glu)

        max_err = max_rel = 0.0
        ctls = [0.0] * DRAWS
        same_rows = total_rows = 0
        for m in TTS_ROWS:
            for lyr in sorted({0, layers - 1}):
                for j in range(DRAWS):
                    got = run_kernel(j, lyr, m)
                    ref = run_plain(j, lyr, m)
                    if got.shape != (m, o) or not torch.isfinite(got).all():
                        fail(f"K1 at m={m} {name}: output "
                             f"{tuple(got.shape)} or non-finite")
                    max_err = max(max_err, float((got - ref).abs().max()))
                    max_rel = max(max_rel, rel_err(got, ref))
                    ctls[j] = max(ctls[j], rel_err(
                        run_plain(j, lyr, m, control=True), ref))
                    a = None if alpha is None else alpha
                    for r in range(m):
                        one = fn(xs[m][j][r:r + 1], qt, layer=lyr, alpha=a)
                        same_rows += int(torch.equal(one[0], got[r]))
                        total_rows += 1
        ctl = min(ctls)
        check_limit(f"K1 at m={list(TTS_ROWS)} {name}", "int8_matvec",
                    max_rel, ctl)
        if same_rows != total_rows:
            fail(f"K1 at m={list(TTS_ROWS)} {name}: {total_rows - same_rows}"
                 f" of {total_rows} rows differ from K1 on that row alone")
        m = TTS_ROWS[-1]
        t_kernel = time_ms(run_kernel, REPS)
        t_plain = time_ms(run_plain, max(REPS // 4, 3))
        lib_layers = min(layers, 2)
        wd = dequantize(_first_layers(qt, lib_layers))   # [n, O, K] bf16

        def run_lib(i):
            y = torch.matmul(xs[m][i % DRAWS].to(torch.bfloat16),
                             wd[i % lib_layers].T)
            if glu:
                gate, value = y.float().chunk(2, dim=-1)
                y = torch.nn.functional.silu(gate) * value
            return y

        t_lib = time_ms(run_lib, REPS)
        del wd
        nbytes = (_qt_layer_bytes(qt, o_full) + m * k * 4
                  + (k * alpha.element_size() if alpha is not None else 0)
                  + m * o * 4)
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * o_full * k, "int8")
        rows.append({
            "kernel": "int8_matvec", "shape": f"TTS {name}, m rows",
            "fmt": qt.fmt, "m_checked": list(TTS_ROWS), "O": o, "K": k,
            "glu": glu, "norm": alpha is not None, "calls_per_frame": 0,
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "control_rel_err": ctl, "tol_rel": TOL["int8_matvec"],
            "rows_equal_one_row": [same_rows, total_rows],
            "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes})
        log(f"  int8_matvec     TTS {name:25s} {qt.fmt} O={o:5d} K={k:5d} "
            f"m {list(TTS_ROWS)} rel_err={max_rel:.2e} (tol "
            f"{TOL['int8_matvec']:g}, control {ctl:.2e}); rows equal to "
            f"one-row K1 {same_rows}/{total_rows}; m={m}: "
            f"{t_kernel * 1e3:8.1f} us  bound {b_ms * 1e3:7.1f} us  plain "
            f"{t_plain * 1e3:9.1f} us  lib {t_lib * 1e3:8.1f} us  [{CARD}]")
    return rows


def check_k7(params, cfg, gen, batch: int):
    """Phase 3: K7 at the pool's shape, the temporal GLU (a layer of the
    fused linear_in, [2 * hidden, dim] q4_k) at m = ``batch`` and
    POOL_M_EXTRA rows, with the fused rms pre-norm (as the pool calls it)
    and without, against the plain version: limit glu_matvec (with the
    norm on the kernel's staged activations, ``GluNorm``), controls the
    weight elements left in f32 and the gate rounded to bf16 before the
    silu.  Timed at m = ``batch`` with
    the norm beside the plain version, one library call (bf16 matmul on
    the dequantized weight, then silu(gate) * value) and the bound."""
    from moshi_tpu_torch.quant import matmul as mm
    from moshi_tpu_torch.quant.formats import dequantize
    lay = params["transformer"]["layers"]
    qt3 = lay["gating"]["linear_in"]["weight"]
    nl = cfg.num_layers
    alphas = lay["norm2"]["alpha"]
    qts = [qt3._map(lambda a, i=i: a[i]) for i in sorted({0, nl - 1})]
    k = qt3.shape[-1]
    h = qt3.q.shape[-2] // 2
    ms = (batch, POOL_M_EXTRA)
    xs = {m: [torch.randn((m, k), generator=gen, device=DEV)
              for _ in range(DRAWS)] for m in ms}
    rows = []
    for norm in (True, False):
        max_err = max_rel = 0.0
        ctls = [0.0] * DRAWS
        staged = GluNorm() if norm else None
        for li, qt in enumerate(qts):
            a = alphas.reshape(-1, k)[li * (nl - 1)] if norm else None
            qte = qt.with_eff_scales()
            for m in ms:
                for j in range(DRAWS):
                    x = xs[m][j]
                    got = mm.glu_matmul(x, qt, alpha=a)
                    ref = mm.glu_matmul_plain(x, qte, a)
                    if got.shape != (m, h) or not torch.isfinite(got).all():
                        fail(f"K7 m={m}: output {tuple(got.shape)} or "
                             f"non-finite")
                    max_err = max(max_err, float((got - ref).abs().max()))
                    max_rel = max(max_rel, rel_err(got, ref))
                    gv = dequant_w_f32(x, qte, 0, a)
                    w32 = mm._silu(gv[:, :h]) * gv[:, h:]
                    ctls[j] = max(ctls[j], min(
                        rel_err(w32, ref),
                        rel_err(glu_gate_bf16(x, qte, 0, a), ref)))
                    if staged:
                        staged.add(got, x, qte, 0, a, j)
        ctl = min(ctls)
        label = "with the fused norm" if norm else "no norm"
        held, reading = held_reading(
            f"K7 temporal GLU at m {list(ms)}, {label}", "glu_matvec",
            staged, max_rel, ctl)
        qt = qts[0]
        a = alphas.reshape(-1, k)[0] if norm else None

        def run_kernel(i):
            return mm.glu_matmul(xs[batch][i % DRAWS], qt, alpha=a)

        def run_plain(i):
            return mm.glu_matmul_plain(xs[batch][i % DRAWS],
                                       qt.with_eff_scales(), a)

        wd = dequantize(qt)

        def run_lib(i):
            y = torch.matmul(xs[batch][i % DRAWS].to(torch.bfloat16), wd.T)
            gate, value = y.float().chunk(2, dim=-1)
            return torch.nn.functional.silu(gate) * value

        t_k = time_ms(run_kernel, REPS)
        t_p = time_ms(run_plain, max(REPS // 4, 3))
        t_l = time_ms(run_lib, REPS)
        del wd
        nbytes = (_qt_layer_bytes(qt, 2 * h) + batch * k * 4
                  + (k * 2 if norm else 0) + batch * h * 4)
        b_ms, b_by = bound_ms(nbytes, 2.0 * batch * 2 * h * k, "bf16")
        rows.append({
            "kernel": "glu_matmul", "shape": f"temporal GLU, {label}",
            "fmt": qt.fmt, "B": batch, "m_checked": list(ms), "O": h,
            "K": k, "glu": True, "norm": norm, "calls_per_frame": 0,
            "calls_per_tts_tick": nl if norm else 0,
            "max_abs_err": max_err, **held, "ms": t_k,
            "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes})
        log(f"  glu_matmul      B={batch} temporal GLU {qt.fmt} H={h} K={k} "
            f"{label:19s} m {list(ms)} {reading}  {t_k * 1e3:8.1f} us  "
            f"bound {b_ms * 1e3:7.1f} us  plain {t_p * 1e3:9.1f} us  lib "
            f"{t_l * 1e3:8.1f} us  x{nl if norm else 0}/tick  [{CARD}]")
    return rows


def check_tts_ring_kernels(cfg, gen, batch: int):
    """Phase 3 at B = ``batch``: K9 over the TTS temporal ring (H 16, hd
    128, cap = context = 500) with every session at another age, some
    wrapped, against the plain version (controls: p in f32, and K3's
    context - 1 mask where a slot sits at that age), and K11 writing every
    session's slot of one layer's ring at once (bit-exact)."""
    from moshi_tpu_torch.nn import decode_attention as da
    from moshi_tpu_torch.nn import ring as rw
    bf = torch.bfloat16
    m = cfg.transformer.mha
    cap, ctx, h, hd = m.cap, cfg.context, m.num_heads, m.head_dim
    nl, row = cfg.num_layers, h * hd
    offs = pool_offsets(cap, batch)
    offset = torch.tensor(offs, dtype=torch.int32, device=DEV)
    kc = torch.randn((batch, cap, h, hd), generator=gen, device=DEV).to(bf)
    vc = torch.randn((batch, cap, h, hd), generator=gen, device=DEV).to(bf)
    qs = [torch.randn((batch, h, hd), generator=gen, device=DEV).to(bf)
          for _ in range(DRAWS)]

    def run_kernel(i):
        return da.decode_attention(qs[i % DRAWS], kc, vc, offset, cap=cap,
                                   context=ctx)

    def run_plain(i, **kw):
        kw.setdefault("context", ctx)
        return da.decode_attention4_plain(qs[i % DRAWS], kc, vc, offset,
                                          cap=cap, **kw)

    def run_lib(i):
        return torch.nn.functional.scaled_dot_product_attention(
            qs[i % DRAWS][:, :, None], kc.transpose(1, 2), vc.transpose(1, 2))

    controls = _k9_controls(da, run_plain, max(offs), cap, ctx, False)
    max_err, max_rel, rule, smallest, rules, asserted, asserted_rule = \
        check_k9(f"decode_attention4 B={batch} (TTS ring, {batch} ages)",
                 run_kernel, run_plain, controls,
                 lambda d: flip_bound(qs[d], kc, vc, offset, cap=cap,
                                      context=ctx))
    t_k = time_ms(run_kernel, REPS)
    t_p = time_ms(run_plain, max(REPS // 4, 3))
    t_l = time_ms(run_lib, REPS)
    valid = sum(min(o + 1, ctx) for o in offs)
    nbytes = valid * row * 2 * 2 + batch * (row * 2 + row * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * valid * row, "f32")
    rows = [{
        "kernel": "decode_attention4", "shape": f"B={batch} TTS ring, "
        f"{batch} ages", "B": batch, "H": h, "hd": hd, "cap": cap,
        "offsets": offs, "calls_per_frame": 0, "calls_per_tts_tick": nl,
        "max_abs_err": max_err, "max_rel_err": max_rel,
        "control_rel_err": asserted, "controls": smallest, "rule": rule,
        "control_rule": asserted_rule, "control_rules": rules,
        "tol_rel": TOL["decode_attention4"], "ms": t_k, "plain_ms": t_p,
        "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "blocks_per_call": k9_blocks(batch, m)}]
    shown = ", ".join(f"{k} {v:.2e} (rule {rules[k]:.3f})"
                      for k, v in smallest.items())
    log(f"  decode_attention4 B={batch} TTS ring, offsets {offs} rel_err="
        f"{max_rel:.2e}, rule {rule:.3f} (tol {TOL['decode_attention4']:g}; "
        f"controls: "
        f"{shown})  {t_k * 1e3:8.1f} us  bound {b_ms * 1e3:6.2f} us  plain "
        f"{t_p * 1e3:9.1f} us  sdpa {t_l * 1e3:7.1f} us  x{nl}/tick  "
        f"{rows[0]['blocks_per_call']} blocks  [{CARD}]")

    # K11: every session's slot of one layer's k and v rings in one launch,
    # from f32 rows a stride apart, as the pool's projection leaves them
    vals = [torch.randn((batch, h, hd), generator=gen, device=DEV).to(bf)
            for _ in range(3)]
    # the v rows: their own draws, so that the later draws stay as they
    # were
    kgen = torch.Generator(device=DEV).manual_seed(SEED + 35)
    kv = [kv_views(x, kgen) for x in vals]
    offsets = [torch.tensor([o + s for o in offs], dtype=torch.int32,
                            device=DEV) for s in range(3)]
    rows.append(k11_pair_row(f"B={batch} TTS ring, one layer",
                             (kc.clone(), vc.clone()), kv, offsets,
                             {"calls_per_tts_tick": nl}))
    return rows


def stt_config(num_layers: int = 0):
    """The dense stt-1b-class LM from ``STT_CONFIG``, built as the tools
    build it (the audio delay from its stt_config), with ``num_layers``
    layers if given."""
    from moshi_tpu_torch.config import load_config
    from moshi_tpu_torch.models.lm import LMConfig
    mc = load_config(str(STT_CONFIG))
    cfg = LMConfig.from_moshi_config(
        mc, audio_delay=mc.stt_config.audio_delay_seconds)
    return dataclasses.replace(cfg, num_layers=num_layers or cfg.num_layers)


def stt_ring_states(cap: int):
    """(label, offset) of K9's three ring states: a fresh session (the
    first chunk only), a partly filled ring (valid slots in two chunks),
    and a wrapped ring past its first cap positions (every slot valid)."""
    return (("fresh session", cap // 8), ("partly filled", (2 * cap) // 3),
            ("wrapped", cap + 37))


def k9_boundary_case(cap: int, h: int, hd: int, gen):
    """(offset, queries, kc, vc) of a wrapped ring on which K9's chunking
    decides the result.  With c = chunk_for(cap) (K3's chunk, 250 at cap
    750), the running max jumps at slot c, inside K9's first chunk
    (min(256, cap)) but at the start of K3's second.  Each query is 8 on
    one dimension and 0 elsewhere, so every score is one exact product.
    Every head's key is 16 at slot c and ``a0`` at slot c // 2 on all
    dimensions, its value -1 and +1 there: K9 rounds slot c // 2's p =
    exp(s0 - s1) to bf16, K3's chunking rounds 1 there and scales it in
    f32.  ``a0`` is the bf16 step below 16 whose p has the largest
    rounding error at least 1/32 of a bf16 step from the rounding
    midpoint, so that an ulp of the scores cannot flip it (at hd 128: a0
    15.375, p 0.6428, error 1.74e-3, 2.1e-4 from the midpoint; the output,
    about -0.22, moves by about 1.3e-3).  The background keys and values
    are N(0, 1), about 1% of the weight.  The offset puts slot c // 2 at
    delta = context - 1 (with context = cap), so K3's mask drops it."""
    from moshi_tpu_torch.nn.decode_attention import chunk4_for, chunk_for
    c = chunk_for(cap)
    if c >= chunk4_for(cap):
        raise ValueError(f"at cap {cap} K3's and K9's chunks are the same")
    bf = torch.bfloat16
    scale = hd ** -0.5
    s1 = torch.tensor([8.0 * 16.0]) * scale
    best = (0.0, 15.0)
    for i in range(1, 32):
        a0 = 16.0 - i / 16
        p = torch.exp(torch.tensor([8.0 * a0]) * scale - s1)
        err = float((p - p.to(bf).float()).abs())
        step = 2.0 ** (float(torch.floor(torch.log2(p))) - 7)
        if step / 2 - err > step / 32 and err > best[0]:
            best = (err, a0)
    kc = torch.randn((1, cap, h, hd), generator=gen, device=DEV)
    vc = torch.randn((1, cap, h, hd), generator=gen, device=DEV)
    kc[:, c // 2], kc[:, c] = best[1], 16.0
    vc[:, c // 2], vc[:, c] = 1.0, -1.0
    qs = []
    for d in range(DRAWS):
        q = torch.zeros((1, h, hd), device=DEV)
        q[..., d] = 8.0
        qs.append(q.to(bf))
    return cap + c // 2 - 1, qs, kc.to(bf), vc.to(bf)


def _k9_controls(da, run_plain, off, cap, context, boundary):
    """(name, asserted, fn(d)) of K9's controls in a ring state.  Each is
    the plain version with one pin changed: p left in f32 (asserted in
    every state), K3's context - 1 mask (asserted where a slot sits at
    delta = context - 1, i.e. once offset >= context - 1), K3's chunking
    (asserted on ``k9_boundary_case``'s ring; on random rings it changes
    the rounding of p only on the few slots between the two chunkings'
    boundaries, where a new running max falls there, so it reads from
    1.7e-4 up, near the card's sound readings, and is logged)."""
    def p_f32(d):
        with swapped(da, "_bf16_round", lambda t: t):
            return run_plain(d)
    return [("p in f32", True, p_f32),
            ("context - 1 mask", off >= context - 1,
             lambda d: run_plain(d, context=context - 1)),
            ("K3 chunking", boundary,
             lambda d: run_plain(d, chunk=da.chunk_for(cap)))]


def check_k9(what, run_kernel, run_plain, controls, bound_of):
    """K9 against its plain version over DRAWS queries (``bound_of(d)``:
    draw d's ``flip_bound``), held by the flip rule, which each asserted
    control of ``controls`` (``_k9_controls``) must break on every draw.
    Returns (largest absolute and relative errors, the rule's reading,
    each control's smallest relative error and smallest rule reading, and
    the smallest of both over the asserted controls)."""
    tol = TOL["decode_attention4"]
    max_err = max_rel = rule = 0.0
    ctl = {name: [] for name, _, _ in controls}
    ctl_rule = {name: [] for name, _, _ in controls}
    for d in range(DRAWS):
        got, ref = run_kernel(d), run_plain(d)
        if not torch.isfinite(got).all():
            fail(f"{what}: non-finite output")
        bound = bound_of(d)
        max_err = max(max_err, float((got - ref).abs().max()))
        max_rel = max(max_rel, rel_err(got, ref))
        rule = max(rule, flip_score(got, ref, bound, tol))
        for name, _, fn in controls:
            out = fn(d)
            ctl[name].append(rel_err(out, ref))
            ctl_rule[name].append(flip_score(out, ref, bound, tol))
    smallest = {name: min(v) for name, v in ctl.items()}
    rules = {name: min(v) for name, v in ctl_rule.items()}
    asserted = min(smallest[name] for name, on, _ in controls if on)
    asserted_rule = min(rules[name] for name, on, _ in controls if on)
    check_rule(what, "decode_attention4", rule, asserted_rule)
    return max_err, max_rel, rule, smallest, rules, asserted, asserted_rule


def kv_views(k, gen):
    """k [B, H, hd] as a layer's projection leaves its rows: the k part of
    a [B, 3 H hd] f32 buffer (a view: the sessions 3 H hd apart), and its
    v part beside it, N(0, 1) from ``gen``."""
    b, h, hd = k.shape
    row = h * hd
    qkv = torch.randn((b, 3 * row), generator=gen, device=DEV)
    qkv[:, row:2 * row] = k.reshape(b, row).float()
    return qkv[:, row:2 * row].view(b, h, hd), qkv[:, 2 * row:].view(b, h, hd)


def k11_pair_row(label, rings, kv, offsets, calls):
    """K11's pair entry (``ring_write_kv``) on ``rings`` (k, v) from the
    rows ``kv`` [(k, v), ...] at ``offsets`` [[B] int32, ...] in turn:
    the kernel against its plain version, bit for bit on copies of the
    rings, then timed beside the plain version, the library (the rows cast
    with ``.to()`` and put into each ring at the slots, worked out
    beforehand: two ``index_put_``) and the bound (the rows read once, the
    ring rows written once).  ``calls``: {the row's calls key: launches
    per frame}."""
    from moshi_tpu_torch.nn import ring as rw
    from moshi_tpu_torch.nn.ring import FP8, ring_bytes
    k_ring, v_ring = rings
    got = [r.clone() for r in rings]
    ref = [r.clone() for r in rings]
    for (k, v), off in zip(kv, offsets):
        rw.ring_write_kv(got[0], got[1], k, v, off)
        rw.ring_write_kv_plain(ref[0], ref[1], k, v, off)
    sync()
    if not all(torch.equal(g.view(torch.uint8), r.view(torch.uint8))
               for g, r in zip(got, ref)):
        fail(f"ring_write4 ({label}): kernel and plain version disagree")
    del got, ref
    n, cap = len(kv), k_ring.shape[1]
    slots = [torch.remainder(o.long(), cap) for o in offsets]
    bi = torch.arange(k_ring.shape[0], device=DEV)

    def run_kernel(i):
        rw.ring_write_kv(k_ring, v_ring, *kv[i % n], offsets[i % n])

    def run_plain(i):
        rw.ring_write_kv_plain(k_ring, v_ring, *kv[i % n], offsets[i % n])

    def run_lib(i):
        for ring, x in zip((k_ring, v_ring), kv[i % n]):
            ring_bytes(ring).index_put_((bi, slots[i % n]),
                                        ring_bytes(x.to(ring.dtype)))

    t_k = time_ms(run_kernel, REPS)
    t_p = time_ms(run_plain, REPS)
    t_l = time_ms(run_lib, REPS)
    b, h, hd = kv[0][0].shape
    nb = 2 * b * h * hd * (kv[0][0].element_size() + k_ring.element_size())
    b_ms, _ = bound_ms(nb, 0.0, "f32")
    fp8 = k_ring.dtype == FP8
    row = {"kernel": "ring_write4_fp8" if fp8 else "ring_write4",
           "shape": label, "B": b, "cap": cap,
           "offsets": [o.tolist() for o in offsets], "calls_per_frame": 0,
           **calls, "max_abs_err": 0.0, "max_rel_err": 0.0, "tol_rel": 0.0,
           "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
           "bound_by": "bytes", "bytes": nb}
    log(f"  {row['kernel']:15s} {label} {tuple(k_ring.shape)}, k and v in "
        f"one launch from {kv[0][0].dtype} rows: exact  {t_k * 1e3:8.1f} us"
        f"  bound {b_ms * 1e3:6.4f} us  plain {t_p * 1e3:8.1f} us  "
        f"index_put_ x2 {t_l * 1e3:7.1f} us  x{max(calls.values())}/frame"
        f"  [{CARD}]")
    return row


def ring_offsets(cap: int):
    """The positions every ring write is checked at: a fresh ring, a young
    one, the last slot, the first wrap, past the second, and the largest
    int32 offset."""
    return [0, 5, cap - 1, cap, 2 * cap + 7, 2 ** 31 - 1]


def _ring_rows(shape, gen, dtype, strided: bool):
    """Rows [..., H, hd] for a ring write in ``dtype``: ``fp8_rows``' probe
    (e4m3 ties, 448-480, 1e6, inf, NaN) with every 7th value moved to a
    bf16 tie; ``strided``: the k part of a [..., 3 H hd] buffer, as
    ``streaming_mha`` passes k and v, else contiguous."""
    *lead, h, hd = shape
    row = h * hd
    x = fp8_rows(shape, gen)
    bits = x.view(torch.int32).view(-1)
    bits[::7] = (bits[::7] & ~0xFFFF) | 0x8000
    x = x.to(dtype)
    if not strided:
        return x
    qkv = torch.zeros((*lead, 3 * row), dtype=dtype, device=DEV)
    qkv[..., row:2 * row] = x.reshape(*lead, row)
    return qkv[..., row:2 * row].view(shape)


def check_ring_writes(scfg, cfg, gen, batch: int):
    """Phase 3 (rings): K11 and K4 against their plain versions on the
    card, bit for bit: the kernel writes a pair of rings and the plain
    version a copy of them, and after every call the whole rings' bytes
    must be equal (``torch.equal``).  K11 on the stt-1b ring (cap 750, H
    16, hd 128): the pair (``ring_write_kv``) and the one-ring entry
    (``ring_write``), bf16 and fp8 rings, f32 and bf16 rows, B = 1 and
    ``batch``, the rows contiguous and strided; K4
    (``ring_write_stacked``) on the 7B temporal rings, every layer at B =
    1 and 2 layers at B = ``batch``, both ring types from f32 and bf16
    rows.  Positions: ``ring_offsets`` (int32) one by one at B = 1, every
    session at another of them (and cap // 3, 3 cap + 1) at B = ``batch``,
    and once as int64 past 2^40.  Returns the calls checked per
    kernel."""
    from moshi_tpu_torch.nn import ring as rw
    bf = torch.bfloat16
    checked = {"ring_write4": 0, "ring_write": 0}

    def positions(cap, b):
        offs = ring_offsets(cap) + [cap // 3, 3 * cap + 1]
        sets = ([[o] for o in ring_offsets(cap)] if b == 1 else
                [[offs[(i + s) % len(offs)] for i in range(b)]
                 for s in (0, 3)])
        return ([torch.tensor(p, dtype=torch.int32, device=DEV)
                 for p in sets]
                + [torch.tensor([2 ** 40 + 5 + 7 * i for i in range(b)],
                                dtype=torch.int64, device=DEV)])

    def new_rings(shape, fp8):
        rings = [fp8_ring(shape, gen) if fp8 else
                 torch.randn(shape, generator=gen, device=DEV).to(bf)
                 for _ in range(2)]
        return rings, [r.clone() for r in rings]

    def same(what, got, ref):
        sync()
        if not all(torch.equal(g.view(torch.uint8), r.view(torch.uint8))
                   for g, r in zip(got, ref)):
            fail(f"{what}: kernel and plain version differ")

    m = scfg.transformer.mha
    cap, h, hd = m.cap, m.num_heads, m.head_dim
    for fp8 in (False, True):
        for rows_dt in (torch.float32, bf):
            for b in (1, batch):
                for strided in (False, True):
                    got, ref = new_rings((b, cap, h, hd), fp8)
                    for pos in positions(cap, b):
                        k = _ring_rows((b, h, hd), gen, rows_dt, strided)
                        v = _ring_rows((b, h, hd), gen, rows_dt, strided)
                        what = (f"K11 {'fp8' if fp8 else 'bf16'} ring, "
                                f"{rows_dt} rows, B={b}, "
                                f"{'strided' if strided else 'contiguous'}"
                                f", positions {pos.tolist()}")
                        rw.ring_write_kv(got[0], got[1], k, v, pos)
                        rw.ring_write_kv_plain(ref[0], ref[1], k, v, pos)
                        same(f"{what}, k and v", got, ref)
                        rw.ring_write(got[0], v, pos)
                        rw.ring_write4_plain(ref[0], v, pos)
                        same(f"{what}, one ring", got, ref)
                        checked["ring_write4"] += 2
                    del got, ref
    tm = cfg.transformer.mha
    h, hd = tm.num_heads, tm.head_dim
    for fp8 in (False, True):
        for rows_dt in (torch.float32, bf):
            for b, layers in ((1, cfg.num_layers), (batch, 2)):
                got, ref = new_rings((layers, b, tm.cap, h, hd), fp8)
                for pos in positions(tm.cap, b):
                    ks = _ring_rows((layers, b, h, hd), gen, rows_dt, False)
                    vs = _ring_rows((layers, b, h, hd), gen, rows_dt, False)
                    rw.ring_write_stacked(got[0], got[1], ks, vs, pos)
                    rw.ring_write_plain(ref[0], ref[1], ks, vs, pos)
                    same(f"K4 {'fp8' if fp8 else 'bf16'} rings "
                         f"[{layers}, {b}, {tm.cap}], {rows_dt} rows, "
                         f"positions {pos.tolist()}", got, ref)
                    checked["ring_write"] += 1
                del got, ref
    log(f"  ring writes: K11 {checked['ring_write4']} calls (the pair and "
        f"the one-ring entry) and K4 {checked['ring_write']} calls equal "
        f"their plain versions, every ring byte  [{CARD}]")
    return checked


def check_stt_kernels(cfg, params, gen):
    """Phase 3 at the stt-1b shapes: K9 over the temporal ring (B 1, H 16,
    hd 128, cap = context = 750) in three ring states and on
    ``k9_boundary_case``'s ring, DRAWS queries each, and K11 into one
    layer's ring (bit-exact), each timed beside its plain version and one
    library call; then the dense product of every stt-1b weight in both
    forms (``qmatmul``'s, which is ``dense_mm`` on the card, and both
    operands widened to f32), which must agree."""
    from moshi_tpu_torch.nn import decode_attention as da
    from moshi_tpu_torch.nn import ring as rw
    from moshi_tpu_torch.quant.formats import qmatmul
    bf = torch.bfloat16
    m = cfg.transformer.mha
    cap, ctx, h, hd = m.cap, cfg.context, m.num_heads, m.head_dim
    nl, row = cfg.num_layers, m.num_heads * m.head_dim
    kc = torch.randn((1, cap, h, hd), generator=gen, device=DEV).to(bf)
    vc = torch.randn((1, cap, h, hd), generator=gen, device=DEV).to(bf)
    qs = [torch.randn((1, h, hd), generator=gen, device=DEV).to(bf)
          for _ in range(DRAWS)]
    cases = [(label, off, qs, kc, vc) for label, off in stt_ring_states(cap)]
    # its own draws, so that the later phases' draws stay as they were
    bgen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    cases.append(("chunk boundary",) + k9_boundary_case(cap, h, hd, bgen))
    rows = []
    for label, off, qs, kc, vc in cases:
        offset = torch.tensor([off], dtype=torch.int32, device=DEV)

        def run_kernel(i):
            return da.decode_attention(qs[i % DRAWS], kc, vc, offset,
                                       cap=cap, context=ctx)

        def run_plain(i, **kw):
            kw.setdefault("context", ctx)
            return da.decode_attention4_plain(qs[i % DRAWS], kc, vc, offset,
                                              cap=cap, **kw)

        def run_lib(i):
            return torch.nn.functional.scaled_dot_product_attention(
                qs[i % DRAWS][:, :, None], kc.transpose(1, 2),
                vc.transpose(1, 2))

        controls = _k9_controls(da, run_plain, off, cap, ctx,
                                label == "chunk boundary")
        max_err, max_rel, rule, smallest, rules, asserted, asserted_rule = \
            check_k9(f"decode_attention4 ({label})", run_kernel, run_plain,
                     controls, lambda d, qs=qs, kc=kc, vc=vc, offset=offset:
                     flip_bound(qs[d], kc, vc, offset, cap=cap, context=ctx))
        tol = TOL["decode_attention4"]
        t_k = time_ms(run_kernel, REPS)
        t_p = time_ms(run_plain, max(REPS // 4, 3))
        t_l = time_ms(run_lib, REPS)
        valid = min(off + 1, ctx)
        nbytes = valid * row * 2 * 2 + row * 2 + row * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * valid * row, "f32")
        rows.append({
            "kernel": "decode_attention4", "shape": f"stt ring, {label}",
            "B": 1, "H": h, "hd": hd, "cap": cap, "offset": off,
            "calls_per_frame": nl if label == "wrapped" else 0,
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "control_rel_err": asserted, "controls": smallest, "rule": rule,
            "control_rule": asserted_rule, "control_rules": rules,
            "tol_rel": tol, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "blocks_per_call": k9_blocks(1, m)})
        shown = ", ".join(f"{k} {v:.2e} (rule {rules[k]:.3f})"
                          for k, v in smallest.items())
        log(f"  decode_attention4 stt ring, {label:14s} (offset {off:4d}) "
            f"rel_err={max_rel:.2e}, rule {rule:.3f} (tol {tol:g}; controls: "
            f"{shown})  "
            f"{t_k * 1e3:8.1f} us  bound {b_ms * 1e3:6.2f} us  plain "
            f"{t_p * 1e3:9.1f} us  sdpa {t_l * 1e3:7.1f} us  "
            f"x{rows[-1]['calls_per_frame']}/frame  "
            f"{rows[-1]['blocks_per_call']} blocks  [{CARD}]")

    # K11: one layer's k and v rings in one launch (one per layer and
    # frame), from f32 rows where the rope and the projection leave them,
    # at a session's offsets
    ring = torch.randn((1, cap, h, hd), generator=gen, device=DEV).to(bf)
    vals = [torch.randn((1, h, hd), generator=gen, device=DEV).to(bf)
            for _ in range(3)]
    # the v ring and the v rows: their own draws, so that the later draws
    # stay as they were
    kgen = torch.Generator(device=DEV).manual_seed(SEED + 34)
    vring = torch.randn((1, cap, h, hd), generator=kgen, device=DEV).to(bf)
    kv = [kv_views(x, kgen) for x in vals]
    offsets = [torch.tensor([o], dtype=torch.int32, device=DEV)
               for o in (5, cap + cap // 3, 2 * cap - 1)]
    rows.append(k11_pair_row("stt ring, one layer", (ring, vring), kv,
                             offsets, {"calls_per_frame": nl}))

    # the dense product of every stt-1b weight, in both forms
    lay = params["transformer"]["layers"]
    dense = []
    for name, w, calls in (
            ("in_proj", lay["self_attn"]["in_proj"]["weight"][0], nl),
            ("out_proj", lay["self_attn"]["out_proj"]["weight"][0], nl),
            ("linear_in", lay["gating"]["linear_in"]["weight"][0], nl),
            ("linear_out", lay["gating"]["linear_out"]["weight"][0], nl),
            ("text_linear", params["text_linear"]["weight"], 1)):
        o, k = w.shape
        xs = [torch.randn((1, k), generator=gen, device=DEV).to(bf)
              for _ in range(DRAWS)]
        worst = max(rel_err(qmatmul(x, w), torch.matmul(x.float(),
                                                        w.float().T))
                    for x in xs)
        if worst > TOL["dense_mm"]:
            fail(f"dense product {name}: the two forms differ by "
                 f"{worst:.3e} > {TOL['dense_mm']:g}")
        t_mm = time_ms(lambda i: qmatmul(xs[i % DRAWS], w), REPS)
        t_f32 = time_ms(lambda i: torch.matmul(xs[i % DRAWS].float(),
                                               w.float().T), REPS)
        nbytes = o * k * 2 + k * 2 + o * 4
        dense.append({"weight": name, "O": o, "K": k, "calls_per_frame": calls,
                      "rel_err": worst, "ms": t_mm, "f32_form_ms": t_f32,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes})
        log(f"  dense product {name:11s} [{o:5d}, {k:5d}] bf16: dense_mm "
            f"{t_mm * 1e3:8.1f} us, f32 form {t_f32 * 1e3:8.1f} us, bound "
            f"{dense[-1]['bound_ms'] * 1e3:7.1f} us; forms differ by "
            f"{worst:.2e}  x{calls}/frame  [{CARD}]")
    per_frame = {key: sum(r[key] * r["calls_per_frame"] for r in dense)
                 for key in ("ms", "f32_form_ms", "bound_ms")}
    log(f"  dense products per frame: dense_mm {per_frame['ms']:.3f} ms, "
        f"f32 form {per_frame['f32_form_ms']:.3f} ms, bound "
        f"{per_frame['bound_ms']:.3f} ms  [{CARD}]")
    return rows, {"weights": dense, "per_frame": per_frame}


# ---------------------------------------------------------------------------
# phases 4 and 5: the frame step
# ---------------------------------------------------------------------------

def _frame(cfg, params, state, other, lm, text=None):
    """One lm_gen_step at temp 0 through its two phases, also returning
    transformer_out and the text logits; ``text`` [B], where given, takes
    the sampled text token's place in the depformer and the delay
    cache."""
    from moshi_tpu_torch.nn.layers import linear
    sampled, h, state = lm.lm_text_step(cfg, params, state,
                                        other_audio=other, temp_text=0.0)
    text = sampled if text is None else text.to(sampled.device)
    logits = linear(params["text_linear"], h, out_dtype=torch.float32)
    out, state = lm.lm_audio_step(cfg, params, state, text, h, temp=0.0)
    return out, state, h, logits


def _session(cfg, params, others, device, caches=None, state=None,
             keep=None, follow=None):
    """Frames at temp 0 from a fresh B = 1 state on ``device`` (or from a
    copy of ``state``).  With ``caches``, each frame after the first
    starts from the delay cache another run left (so both runs take the
    same input tokens); with ``follow`` (another run's frames), each
    frame's depformer steps and delay cache take that run's text and
    depformer tokens (so that a token sampled apart at a near-tie does not
    change a later input), while "text" records this run's own choice.
    The depformer's logits are taken from its sampler on the way (None
    without a depformer), and the VAD where the model has one.
    ``keep["state"]`` receives the final state."""
    from moshi_tpu_torch.models import lm
    state = (lm.init_gen_state(cfg, 1, device=device) if state is None
             else _state_copy(state, device))
    res = []
    dep, dep_tokens = [], []
    sample = lm.sample_token

    def recorded(logits, *a, **kw):
        if logits.shape[-1] != cfg.card:
            return sample(logits, *a, **kw)
        dep.append(logits.float().cpu())
        tok = sample(logits, *a, **kw)
        if follow is not None:
            tok = follow[f]["dep_tokens"][:, len(dep) - 1].to(tok.device)
        dep_tokens.append(tok.cpu())
        return tok

    for f, other in enumerate(others):
        if caches is not None and f:
            state["cache"] = caches[f - 1].to(device)
        dep.clear()
        dep_tokens.clear()
        with swapped(lm, "sample_token", recorded):
            out, state, h, logits = _frame(
                cfg, params, state, other.to(device), lm,
                None if follow is None else follow[f]["text"])
        res.append({"h": h.cpu(), "logits": logits.cpu(),
                    "dep_logits": torch.stack(dep, 1) if dep else None,
                    "dep_tokens": (torch.stack(dep_tokens, 1) if dep_tokens
                                   else None),
                    "vad": out["vad"].cpu() if "vad" in out else None,
                    "text": (out["sampled_text"] if follow is None
                             else logits.argmax(-1)).cpu(),
                    "tokens": torch.cat([out["text"][:, None],
                                         out["audio"]], dim=1).cpu(),
                    "cache": state["cache"].cpu()})
    if keep is not None:
        keep["state"] = state
    return res


def _state_copy(state, device):
    """A copy of a state tree on ``device`` (its rings are written in
    place, so runs from one state each take their own)."""
    if isinstance(state, dict):
        return {k: _state_copy(v, device) for k, v in state.items()}
    return state.to(device, copy=True)


def _gap(logits):
    """Top-1 minus top-2 of each row, relative to the row's largest
    magnitude."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) / logits.float().abs().amax(-1)


def _compare(card, cpu, tol, tol_dep, tol_vad=0.0, decided_only=False):
    """Card (or control) frames against CPU frames: the largest relative
    error of transformer_out, of the text logits, of the depformer's
    logits and of the VAD (the last two where the model has them), the
    tokens that agree, and whether the check passes: the first two errors
    within ``tol``, the depformer's within ``tol_dep``, the VAD's within
    ``tol_vad``, and the tokens equal: every token, or with
    ``decided_only`` the text tokens where the CPU's top-1/top-2 logit gap
    exceeds ``tol`` and the depformer's where its gap exceeds
    ``tol_dep``."""
    worst = {"transformer_out": 0.0, "logits": 0.0, "dep_logits": None,
             "vad": None}
    agree = total = 0
    for a, c in zip(card, cpu):
        for key, name in (("h", "transformer_out"), ("logits", "logits"),
                          ("dep_logits", "dep_logits"), ("vad", "vad")):
            if c[key] is not None:
                worst[name] = max(worst[name] or 0.0, rel_err(a[key], c[key]))
        if decided_only:
            ok = _gap(c["logits"]) > tol
            agree += int((a["text"] == c["text"])[ok].sum())
            total += int(ok.sum())
            if c["dep_logits"] is not None:
                ok = _gap(c["dep_logits"]) > tol_dep
                agree += int((a["dep_logits"].argmax(-1)
                              == c["dep_logits"].argmax(-1))[ok].sum())
                total += int(ok.sum())
            continue
        for key in ("text", "tokens"):
            agree += int((a[key] == c[key]).sum())
            total += c[key].numel()
    passes = (max(worst["transformer_out"], worst["logits"]) <= tol
              and (worst["dep_logits"] or 0.0) <= tol_dep
              and (worst["vad"] or 0.0) <= tol_vad and agree == total)
    return dict(worst, tokens_agree=agree, tokens_total=total,
                passes=passes)


def _show(r):
    tail = "".join(f", {label} {r[key]:.2e}" for key, label in (
        ("dep_logits", "depformer logits"), ("vad", "VAD"))
        if r[key] is not None)
    return (f"transformer_out {r['transformer_out']:.2e}, logits "
            f"{r['logits']:.2e}{tail}, tokens {r['tokens_agree']}/"
            f"{r['tokens_total']}")


def _frame_controls(form):
    """(name, context manager) of the controls of a frame comparison in
    fusion form ``form``: the CPU side with one rounding changed."""
    from moshi_tpu_torch.nn import decode_attention as da
    from moshi_tpu_torch.quant import fused
    controls = [("K1 bf16 partials", k1_control),
                ("K3 p in f32", lambda: swapped(da, "_bf16_round",
                                                lambda t: t))]
    if form == "1":
        controls.append(("K5 h_mid in bf16", lambda: swapped(
            fused, "attn_ffn_fused_plain", fused_control)))
    return controls


@reused_plain_weights()
def compare_two_layers(form):
    """Phase 4: 2 layers of the 7B geometry, card against CPU, for
    SEEDS_2L weight seeds, in fusion form ``form``; the controls run on
    the first seed."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = lm.LMConfig(delays=_7B_DELAYS, num_layers=2)
    tol, tol_dep = TOL["frame_2l"], TOL["frame_2l_dep"]
    readings, controls = [], {}
    with fusion(form):
        for s in range(SEEDS_2L):
            params = synth_lm_params(cfg, "q4_k", device=DEV,
                                     seed=SEED + 1 + s)
            params_cpu = tree_to(params, "cpu")
            gen = torch.Generator().manual_seed(SEED + 100 + s)
            others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                                    generator=gen) for _ in range(FRAMES_2L)]
            card = _session(cfg, params, others, DEV)
            caches = [r["cache"] for r in card]
            cpu = _session(cfg, params_cpu, others, "cpu", caches)
            r = dict(_compare(card, cpu, tol, tol_dep), seed=SEED + 1 + s)
            readings.append(r)
            log(f"  fuse {form}, seed {SEED + 1 + s}: {_show(r)}")
            if s == 0:
                for name, ctx in _frame_controls(form):
                    with ctx():
                        ctl = _session(cfg, params_cpu, others, "cpu",
                                       caches)
                    controls[name] = _compare(ctl, cpu, tol, tol_dep)
                    log(f"  fuse {form}, control ({name}) against the CPU: "
                        f"{_show(controls[name])}")
    for r in readings:
        if not r["passes"]:
            fail(f"2-layer frame, fuse {form}, seed {r['seed']}: card and "
                 f"CPU differ beyond {tol:g} (depformer {tol_dep:g}) or in "
                 f"a token: {_show(r)}")
    for name, c in controls.items():
        if c["passes"]:
            fail(f"2-layer frame, fuse {form}: the control ({name}) passes "
                 f"the check: it cannot tell that rounding apart")
    return {"form": form, "frames": FRAMES_2L, "readings": readings,
            "controls": controls, "tol_rel": tol, "tol_dep_rel": tol_dep}


@reused_plain_weights()
def compare_full_depth(cfg, params):
    """Phase 4, second part: the 32-layer 7B in the fused form, card
    against CPU, for FRAMES_32L frames of a fresh session, and the
    controls."""
    tol, tol_dep = TOL["frame_32l"], TOL["frame_32l_dep"]
    gen = torch.Generator().manual_seed(SEED + 200)
    others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                            generator=gen) for _ in range(FRAMES_32L)]
    with fusion("1"):
        card = _session(cfg, params, others, DEV)
        caches = [r["cache"] for r in card]
        params_cpu = tree_to(params, "cpu")
        cpu = _session(cfg, params_cpu, others, "cpu", caches)
        controls = {}
        for name, ctx in _frame_controls("1"):
            if name.startswith("K3"):
                continue        # the 2-layer frames hold K3's control
            with ctx():
                ctl = _session(cfg, params_cpu, others, "cpu", caches)
            controls[name] = _compare(ctl, cpu, tol, tol_dep)
    del params_cpu
    r = _compare(card, cpu, tol, tol_dep)
    log(f"  32-layer 7B, fused, {FRAMES_32L} frames at temp 0: {_show(r)}")
    for name, c in controls.items():
        log(f"  control ({name}) against the CPU: {_show(c)}")
    if not r["passes"]:
        fail(f"32-layer frame: card and CPU differ beyond {tol:g} "
             f"(depformer {tol_dep:g}) or in a token")
    for name, c in controls.items():
        if c["passes"]:
            fail(f"32-layer frame: the control ({name}) passes the check: "
                 f"it cannot tell that rounding apart")
    return dict(r, frames=FRAMES_32L, tol_rel=tol, tol_dep_rel=tol_dep,
                controls=controls)


def pool_state(cfg, batch: int, gen, offsets=None):
    """A B = ``batch`` LM state whose sessions are at ``offsets`` (by
    default ``pool_offsets``' ages), with every KV ring slot and
    delay-cache slot filled with random values (the offsets' masks decide
    which slots count)."""
    from moshi_tpu_torch.models import lm
    state = lm.init_gen_state(cfg, batch, device=DEV)
    fill_rings(state, gen)
    state["cache"] = torch.randint(0, cfg.card, state["cache"].shape,
                                   generator=gen, device=DEV)
    state["offset"].copy_(torch.tensor(
        offsets or pool_offsets(cfg.transformer.mha.cap, batch),
        dtype=torch.int32))
    return state


def _pool_controls():
    """(name, context manager) of the controls of a B > 1 frame comparison:
    the CPU side with one rounding changed, in the kernels a batched frame
    runs.  K8's gate rounding moves the synthetic frame little (the
    feed-forwards add little to the residual); phase 3 holds it at the
    kernel."""
    from moshi_tpu_torch.nn import decode_attention as da
    from moshi_tpu_torch.quant import matmul as mm
    return [("K3 p in f32",
             lambda: swapped(da, "_bf16_round", lambda t: t)),
            ("dequant activations in f32",
             lambda: swapped(mm, "_dequant_product", dequant_act_f32))]


@reused_plain_weights()
def compare_pool_two_layers(batch: int):
    """Phase 4 at B = ``batch``: 2 layers of the 7B geometry, card against
    CPU from a state whose sessions are at ``batch`` different ages, for
    SEEDS_POOL weight seeds of FRAMES_2L frames; the controls on the first
    seed.  Every product takes the dequant kernels (K2, K6, K8)."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = lm.LMConfig(delays=_7B_DELAYS, num_layers=2)
    tol, tol_dep = TOL["pool_2l"], TOL["pool_2l_dep"]
    readings, controls = [], {}
    for s in range(SEEDS_POOL):
        params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 30 + s)
        params_cpu = tree_to(params, "cpu")
        gen = torch.Generator().manual_seed(SEED + 130 + s)
        others = [torch.randint(0, cfg.card, (batch, cfg.n_q - cfg.dep_q),
                                generator=gen) for _ in range(FRAMES_2L)]
        state = pool_state(cfg, batch, torch.Generator(device=DEV)
                           .manual_seed(SEED + 230 + s))
        card = _session(cfg, params, others, DEV, state=state)
        caches = [r["cache"] for r in card]
        cpu = _session(cfg, params_cpu, others, "cpu", caches, state=state)
        r = dict(_compare(card, cpu, tol, tol_dep, decided_only=True),
                 seed=SEED + 30 + s)
        readings.append(r)
        log(f"  B={batch}, seed {SEED + 30 + s}: {_show(r)}")
        if s == 0:
            for name, ctx in _pool_controls():
                with ctx():
                    ctl = _session(cfg, params_cpu, others, "cpu", caches,
                                   state=state)
                controls[name] = _compare(ctl, cpu, tol, tol_dep,
                                          decided_only=True)
                log(f"  B={batch}, control ({name}) against the CPU: "
                    f"{_show(controls[name])}")
        del params, params_cpu, state
    for r in readings:
        if not r["passes"]:
            fail(f"2-layer frame at B={batch}, seed {r['seed']}: card and "
                 f"CPU differ beyond {tol:g} (depformer {tol_dep:g}) or in "
                 f"a token: {_show(r)}")
    for name, c in controls.items():
        if c["passes"]:
            fail(f"2-layer frame at B={batch}: the control ({name}) passes "
                 f"the check: it cannot tell that rounding apart")
    return {"batch": batch,
            "offsets": pool_offsets(cfg.transformer.mha.cap, batch),
            "frames": FRAMES_2L, "readings": readings, "controls": controls,
            "tol_rel": tol, "tol_dep_rel": tol_dep}


def _stt_controls():
    """(name, context manager) of the controls of an STT frame comparison:
    the CPU side with one rounding changed."""
    from moshi_tpu_torch.nn import decode_attention as da
    from moshi_tpu_torch.nn import layers
    qmatmul = layers.qmatmul

    def bf16_products(x, w, out_dtype=None, pre_norm_alpha=None):
        y = _bf16_round(qmatmul(x, w, pre_norm_alpha=pre_norm_alpha))
        return y if out_dtype is None else y.to(out_dtype)

    return [("K9 p in f32", lambda: swapped(da, "_bf16_round", lambda t: t)),
            ("dense products rounded to bf16",
             lambda: swapped(layers, "qmatmul", bf16_products))]


_STT_CONTROLS = ("K9 p in f32", "dense products rounded to bf16")


def _stt_check(cfg, params, others, tol, controls):
    """STT frames on the card against the CPU on the same weights and
    inputs, and each of the named ``controls`` against the CPU."""
    tol_vad = TOL["stt_vad"]
    card = _session(cfg, params, others, DEV)
    caches = [r["cache"] for r in card]
    params_cpu = tree_to(params, "cpu")
    cpu = _session(cfg, params_cpu, others, "cpu", caches)
    reading = _compare(card, cpu, tol, 0.0, tol_vad, decided_only=True)
    ctl = {}
    for name, ctx in _stt_controls():
        if name not in controls:
            continue
        with ctx():
            frames = _session(cfg, params_cpu, others, "cpu", caches)
        ctl[name] = _compare(frames, cpu, tol, 0.0, tol_vad,
                             decided_only=True)
    return reading, ctl


def _stt_others(cfg, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.runtime_dep_q),
                          generator=gen) for _ in range(n)]


def compare_stt(full_cfg, full_params):
    """Phase 4 for the STT: 2 layers of the stt-1b geometry, card against
    CPU, for SEEDS_2L weight seeds of FRAMES_2L frames (the controls on the
    first), then the full 16-layer STT for FRAMES_STT_FULL frames with the
    controls.  transformer_out, the text logits and the VAD are each held
    to their limit, and the text tokens must agree wherever the CPU's
    top-1/top-2 gap exceeds the frame limit."""
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = dataclasses.replace(full_cfg, num_layers=2)
    out = {"two_layer": [], "tol_rel": TOL["stt_frame_2l"],
           "tol_16l_rel": TOL["stt_frame_16l"], "tol_vad_rel": TOL["stt_vad"]}
    checks = []
    for s in range(SEEDS_2L):
        params = synth_lm_params(cfg, None, device=DEV, seed=SEED + 20 + s)
        r, ctl = _stt_check(cfg, params, _stt_others(cfg, FRAMES_2L,
                                                     SEED + 120 + s),
                            TOL["stt_frame_2l"],
                            controls=_STT_CONTROLS if s == 0 else ())
        out["two_layer"].append(dict(r, seed=SEED + 20 + s))
        checks.append((f"STT 2-layer frame, seed {SEED + 20 + s}", r, ctl))
        del params
    r, ctl = _stt_check(full_cfg, full_params,
                        _stt_others(full_cfg, FRAMES_STT_FULL, SEED + 220),
                        TOL["stt_frame_16l"],
                        controls=_STT_CONTROLS[1:])  # K9's: 2 layers only
    out["full_depth"] = dict(r, frames=FRAMES_STT_FULL, controls=ctl)
    out["two_layer_controls"] = checks[0][2]
    checks.append((f"STT {full_cfg.num_layers}-layer frame", r, ctl))
    for what, r, ctl in checks:
        log(f"  {what}: {_show(r)}")
        for name, c in ctl.items():
            log(f"    control ({name}) against the CPU: {_show(c)}")
    for what, r, ctl in checks:
        if not r["passes"]:
            fail(f"{what}: card and CPU differ beyond the limit or in a "
                 f"decided token: {_show(r)}")
        for name, c in ctl.items():
            if c["passes"]:
                fail(f"{what}: the control ({name}) passes the check: it "
                     f"cannot tell that rounding apart")
    return out


def stt_launches(cfg):
    """Kernel launches one STT frame makes: per layer, K11 writes k and v
    (one launch) and K9 attends once; nothing else of the port's kernels
    runs."""
    return {"decode_attention4": cfg.num_layers,
            "ring_write4": cfg.num_layers}


def stt_floor_ms(cfg, params, valid: float):
    """Bytes one STT frame must move over the HBM rate: the temporal
    stack's and the text head's weights, VAD head 2, the embedding rows,
    ``valid`` k and v rows read from each layer's ring, and one written."""
    from moshi_tpu_torch.runtime.synth import tree_nbytes
    row = cfg.dim * 2
    nbytes = (tree_nbytes(params["transformer"])
              + tree_nbytes(params["text_linear"])
              + tree_nbytes(params["out_norm"])
              + cfg.extra_heads_dim * cfg.dim * 2
              + (cfg.n_q + 1) * row
              + 2 * cfg.num_layers * (valid + 1) * row)
    return nbytes / HBM_BYTES_PER_S * 1e3


def per_frame_launches(cfg, fused: bool = True):
    """Kernel launches one frame makes at B = 1 (the dispatch in
    quant/formats.int8_shape_ok: the 7B depformer linear_out, q4_0 at
    K = 4224, is the only matvec on the dequant kernel).  Each int8
    matvec is one launch, which stages its activation itself.  In the
    fused form K5 takes each layer's out_proj and GLU."""
    t, d = cfg.num_layers, cfg.depformer_layers * cfg.dep_q
    if fused:
        counts = {"int8_matvec": 2 * t + 1 + 1 + d + cfg.dep_q,
                  "attn_ffn_fused": t + d}
    else:
        counts = {"int8_matvec": 4 * t + 1 + 1 + 3 * d + cfg.dep_q}
    counts.update({"dequant_matvec": d, "decode_attention": t + d,
                   "ring_write": 1})
    return counts


# pieces of the names of PyTorch's elementwise and cat kernels: what slot
# arithmetic, casts and copies launch (remainder, .to(), .contiguous(),
# copy_), and what the rope launches
_TORCH_ELEMENTWISE = ("elementwise_kernel", "CatArrayBatchedCopy")
# profiles of the rope taken before its kernels are given up: one in a
# process that has profiled before may come back empty
ROPE_PROFILES = 3
_ROPE_SEQ: dict = {}      # (B, heads, head dim) -> the rope's kernels


def rope_kernels(b: int, heads: int, hd: int):
    """The kernels ``apply_rope`` launches on a layer's q and k as
    ``streaming_mha`` passes them (a [B, 1, 2H, hd] view of an f32 [B, 1,
    3 H hd] projection), in launch order: the kernels after the last spin
    kernel in a profile of three calls, each behind a spin (after a
    warm-up; the profiler may miss the first kernels of its window).  A
    profile that caught no kernel at all is taken again, up to
    ``ROPE_PROFILES`` times; each shape is profiled once a process."""
    key = (b, heads, hd)
    if key not in _ROPE_SEQ:
        _ROPE_SEQ[key] = _profile_rope(b, heads, hd)
    return _ROPE_SEQ[key]


def _profile_rope(b: int, heads: int, hd: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from moshi_tpu_torch.nn.rope import apply_rope, rope_angles
    qkv = torch.randn((b, 1, 3 * heads * hd), device=DEV)
    cos_sin = rope_angles(torch.zeros((b, 1), dtype=torch.long,
                                      device=DEV), hd)

    def run():
        apply_rope(qkv[..., :2 * heads * hd].reshape(b, 1, 2 * heads, hd),
                   cos_sin=cos_sin)
        sync()

    run()
    for _ in range(ROPE_PROFILES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
                run()
        seq = [e.name for e in sorted((e for e in prof.events()
                                       if e.device_type == DeviceType.CUDA),
                                      key=lambda e: e.time_range.start)]
        if seq:
            break
    spins = [i for i, n in enumerate(seq) if "spin_kernel" in n]
    if not spins:
        fail(f"the rope's profile holds no spin kernel: {seq}")
    return seq[spins[-1] + 1:]


def check_ring_write_sequence(label, names, per_frame: int, frames: int,
                              rope):
    """The kernels around each K11 launch in a profile's launch order
    ``names``.  Fails if the frames launched other than ``per_frame`` ring
    writes each; if the kernels between a layer's projection (the last
    kernel before the ring write that is neither PyTorch's elementwise or
    copy kernel nor one of the rope's) and its ring write are other than
    the rope's (``rope``: ``rope_kernels`` at the frame's shape), or than
    none where the layer has no rope; or if anything runs between the
    ring write and its K9 launch but K9's own query cast (one copy
    kernel).  Returns the first ring write's kernels before and after it,
    for the log."""
    at = [i for i, n in enumerate(names) if "ring_write_kernel" in n]
    if len(at) != per_frame * frames:
        fail(f"{label}: {len(at)} ring-write launches in the profile of "
             f"{frames} frames, expected {per_frame} a frame")
    first = None
    for i in at:
        j = i
        while j > 0 and (names[j - 1] in rope or any(
                p in names[j - 1] for p in _TORCH_ELEMENTWISE)):
            j -= 1
        before = names[j:i]
        k = i + 1
        while k < len(names) and "split_kernel" not in names[k]:
            k += 1
        after = names[i + 1:k]
        if j == 0 or before not in (rope, []) or k == len(names) or \
                len(after) > 1 or any("copy_kernel" not in n for n in after):
            fail(f"{label}: slot arithmetic or a copy around a ring write: "
                 f"after the projection {names[max(0, j - 1):i]} (the "
                 f"rope's: {rope}), between it and K9 {after}")
        first = first or {"projection": names[j - 1], "before": before,
                          "after": after}
    return first


def _profile(label, run_frame, n: int = PROFILE_FRAMES,
             ring_writes: int = 0, rope=None):
    """Device time by kernel over ``n`` frames (``run_frame(f)`` runs frame
    f and fetches its result), after one unprofiled frame, and the share
    of their wall time the device was busy; on the card, with
    ``ring_writes`` (K11 launches a frame) and ``rope`` (B, heads, head
    dim of the frame's rope), the kernels around each ring write are held
    by ``check_ring_write_sequence``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_frame(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(n):
            run_frame(f + 1)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    window = None
    if ring_writes and DEV == "cuda":
        seq = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        window = check_ring_write_sequence(label, [e.name for e in seq],
                                           ring_writes, n,
                                           rope_kernels(*rope))
        short = {k: [x[:48] for x in window[k]] for k in ("before",
                                                           "after")}
        log(f"  {label}: around each ring write, as the rope and K9's "
            f"query cast launch them: projection "
            f"{window['projection'][:48]}, then {short}")
    # kernels only: a PyTorch op's own entry repeats its kernels' time
    events = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e[1])
    busy = sum(e[1] for e in events)
    host = [(e.key, e.self_cpu_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    host.sort(key=lambda e: -e[1])
    host_ops = sum(e[1] for e in host)
    launches = sum(e[2] for e in events)
    log(f"  {label}, profile over {n} frames: wall {wall_ms:.3f} ms/frame, "
        f"device busy {busy:.3f} ms/frame ({100 * busy / wall_ms:.1f}%), "
        f"{launches:.0f} kernel launches/frame  [{CARD}]")
    for key, ms, count in events[:12]:
        log(f"    {ms:8.3f} ms/frame  x{count:6.1f}  {key[:90]}")
    # host: PyTorch ops and runtime calls by their own time; the rest of
    # the wall time is Python between them (all inflated by the profiler)
    log(f"  host: {host_ops:.3f} ms/frame inside PyTorch ops and CUDA "
        f"runtime calls, {wall_ms - host_ops:.3f} ms/frame outside them")
    for key, ms, count in host[:12]:
        log(f"    {ms:8.3f} ms/frame  x{count:6.1f}  {key[:90]}")
    return {"frames": n, "wall_ms_per_frame": wall_ms,
            "ring_write_window": window,
            "device_busy_ms_per_frame": busy,
            "kernel_launches_per_frame": launches,
            "host_ops_ms_per_frame": host_ops,
            "kernels": [{"name": k, "ms_per_frame": ms, "per_frame": c}
                        for k, ms, c in events],
            "host_ops": [{"name": k, "ms_per_frame": ms, "per_frame": c}
                         for k, ms, c in host]}


def profile_frames(cfg, params, fused: bool = True, mega: bool = False,
                   label=None):
    """The LM frame (fresh session, temp 0) in the fused (or the unfused)
    form under the profiler; with ``mega`` (under the caller's
    MOSHI_TPU_MEGAKERNEL=all) the megakernel frame; ``label`` names a
    knob path the caller set."""
    from moshi_tpu_torch.models import lm
    gen = torch.Generator().manual_seed(SEED + 4)
    others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                            generator=gen).to(DEV)
              for _ in range(PROFILE_FRAMES + 1)]
    box = {"state": lm.init_gen_state(cfg, 1, device=DEV,
                                      params=params if mega else None)}

    def run_frame(f):
        out, box["state"] = lm.lm_gen_step(cfg, params, box["state"],
                                           other_audio=others[f], temp=0.0,
                                           temp_text=0.0)
        out["sampled_text"].cpu()

    label = label or ("megakernels" if mega else "fused" if fused
                      else "unfused")
    with fusion("1" if fused else "0"):
        return _profile(f"LM frame, {label}", run_frame)


def profile_sts(cfg, params, mimi, mparams, mega: bool = False):
    """The STS frame (sampling defaults) under the profiler; with ``mega``
    (under the caller's MOSHI_TPU_MEGAKERNEL=all) on the megakernels."""
    from moshi_tpu_torch.runtime.pipeline import STSPipeline
    pipe = STSPipeline(mimi, cfg, device=DEV)
    audio = _sts_inputs(pipe.frame_samples, PROFILE_FRAMES + 1, SEED + 9)
    box = {"state": pipe.init_state(1, seed=SEED + 9,
                                    lm_params=params if mega else None)}

    def run_frame(f):
        out, box["state"] = pipe.step(mparams, params, box["state"],
                                      audio[f])
        out["audio_out"].cpu()

    return _profile("STS frame, megakernels" if mega else "STS frame",
                    run_frame)


def profile_stt(cfg, params, mimi, mparams, label="STT frame"):
    """The STT frame (STTPipeline, text at temp 0) under the profiler, the
    kernels around its ring writes held."""
    from moshi_tpu_torch.runtime.pipeline import STTPipeline
    pipe = STTPipeline(mimi, cfg, device=DEV)
    audio = _sts_inputs(pipe.frame_samples, PROFILE_FRAMES + 1, SEED + 15)
    box = {"state": pipe.init_state(1, seed=SEED + 15)}

    def run_frame(f):
        out, box["state"] = pipe.step(mparams, params, box["state"],
                                      audio[f])
        out["text"].cpu()

    m = cfg.transformer.mha
    return _profile(label, run_frame, ring_writes=cfg.num_layers,
                    rope=(1, m.num_heads, m.head_dim))


def fill_rings(state, gen):
    """Every KV ring slot of ``state`` filled with N(0, 1) values (on fp8
    rings, cast by the reference's rule)."""
    from moshi_tpu_torch.nn.ring import FP8, fp8_cast
    for ring in state["transformer"].values():
        if ring.dtype == FP8:
            ring.copy_(fp8_cast(torch.randn(ring.shape, generator=gen,
                                            device=ring.device)))
        else:
            ring.normal_(generator=gen)


def long_session_state(cfg, gen):
    """A session past its first ring's worth of frames: offset
    cap + 37, every KV ring slot and delay-cache slot filled with random
    values, so each temporal attention reads its whole window (2999 slots
    on the 7B, 750 on the stt-1b)."""
    from moshi_tpu_torch.models import lm
    state = lm.init_gen_state(cfg, 1, device=DEV)
    fill_rings(state, gen)
    state["cache"] = torch.randint(0, cfg.card, state["cache"].shape,
                                   generator=gen, device=DEV)
    state["offset"].fill_(cfg.transformer.mha.cap + 37)
    return state


def run_lm(cfg, params, label, state, floor_ms, fused: bool = True,
           per_frame=None, model: str = "7B q4_k"):
    """The LM path: WARMUP + FRAMES frames from ``state`` in the fused (or
    the unfused) form, the launch counts zeroed just before and read just
    after and held to ``per_frame`` (by default the 7B frame's)."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models import lm
    gen = torch.Generator().manual_seed(SEED + 3)
    n = WARMUP + FRAMES
    others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                            generator=gen).to(DEV) for _ in range(n)]
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with fusion("1" if fused else "0"):
        build.COUNTS.clear()                  # the path starts here
        times, digests, texts, audios = [], [], [], []
        for f in range(n):
            t0 = time.perf_counter()
            out, state = lm.lm_gen_step(cfg, params, state,
                                        other_audio=others[f], temp=0.0,
                                        temp_text=0.0)
            toks = torch.cat([out["sampled_text"][:, None], out["audio"],
                              out["text"][:, None]], dim=1)
            host = toks.cpu()                 # synchronizes
            dt = time.perf_counter() - t0
            if f >= WARMUP:
                times.append(dt)
            digests.append(int((host.long() * torch.arange(
                1, host.shape[1] + 1)).sum()))
            texts.append(int(out["sampled_text"][0]))
            audios.append(host[0, 1:1 + cfg.dep_q].tolist())
        counts = dict(build.COUNTS)           # the path ends here
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    per_frame = per_frame or per_frame_launches(cfg, fused)
    if counts != {k: v * n for k, v in per_frame.items()}:
        fail(f"{label}: launch counts over {n} frames: {counts}, expected "
             f"{per_frame} per frame")
    if not all(0 <= t < cfg.text_card for t in texts):
        fail(f"{label}: text tokens out of range: {texts}")
    flat = [a for row in audios for a in row]
    if not all(-2 <= a < cfg.card for a in flat):
        fail(f"{label}: audio tokens out of range: {audios}")
    # each frame's own other_audio must reach its tokens
    if len(set(digests[2:])) < 2:
        fail(f"{label}: the tokens do not depend on the input: {digests}")
    ms = sorted(t * 1e3 for t in times)
    mean = sum(ms) / len(ms)
    log(f"  {model} lm_gen_step B=1, {label}: {FRAMES} timed frames after "
        f"{WARMUP} warm-up; ms/frame mean {mean:.3f}, p50 "
        f"{ms[len(ms) // 2]:.3f}, min {ms[0]:.3f}, max {ms[-1]:.3f}; "
        f"frames/s {1e3 / mean:.3f}; HBM floor {floor_ms:.3f} ms/frame; "
        f"peak memory {peak / 2 ** 30:.3f} GiB  [{CARD}]")
    counted = {k: v // n for k, v in counts.items()}
    log(f"  launches per frame (counted over {n} frames): {counted}")
    log(f"  token digests: {digests}")
    return {"model": model, "state": label, "fused": fused, "warmup": WARMUP,
            "frames": FRAMES,
            "ms_per_frame": ms, "ms_per_frame_mean": mean,
            "frames_per_s": 1e3 / mean, "hbm_floor_ms": floor_ms,
            "peak_memory_bytes": peak, "launches": counts,
            "launches_per_frame": counted, "digests": digests,
            "text_tokens": texts}


# ---------------------------------------------------------------------------
# phases 6 and 7: Mimi and the STS frame
# ---------------------------------------------------------------------------

def mimi_row_gaps(params, q_in, codes, n_q):
    """Per row and codebook of the split quantizer's chain [..., n_q]: the
    top-1/top-2 score gap relative to the row's largest |score|, along
    ``codes`` from the quantizer input ``q_in``."""
    from moshi_tpu_torch.nn.layers import linear
    from moshi_tpu_torch.nn.vq import codebook_decode
    gaps = []
    for name, lo, n in (("rvq_first", 0, 1), ("rvq_rest", 1, n_q - 1)):
        br = params["quantizer"][name]
        r = linear(br["input_proj"], q_in)
        for i in range(n):
            e = br["embeddings"][i].float()
            sc = 2.0 * torch.matmul(r.float(), e.T) - (e * e).sum(-1)
            top2 = torch.topk(sc, 2, dim=-1).values
            gaps.append((top2[..., 0] - top2[..., 1]) / sc.abs().amax(-1))
            r = r - codebook_decode(br["embeddings"][i],
                                    codes[..., lo + i]).to(r.dtype)
    return torch.stack(gaps, dim=-1)


def mimi_chain_gaps(params, q_in, codes, n_q):
    """Per codebook of the split quantizer's chain, the smallest
    top-1/top-2 score gap over the rows, relative to the row's largest
    |score|, along ``codes`` from the quantizer input ``q_in``."""
    gaps = mimi_row_gaps(params, q_in, codes, n_q)
    return [float(g) for g in gaps.reshape(-1, n_q).amin(0)]


def decided_codes(params, q_in, ref, got, n_q):
    """(decided, equal): the codes of ``ref`` [B, N, n_q] that its
    quantizer decides (in each row the books of the chain up to the first
    whose top-1/top-2 gap, from ``ref``'s quantizer input ``q_in``, is
    within ``TOL["mimi_gap"]``), and how many of them ``got`` equals."""
    gaps = mimi_row_gaps(params, q_in, ref, n_q)
    held = torch.cumprod((gaps > TOL["mimi_gap"]).int(), dim=-1).bool()
    return int(held.sum()), int(((got == ref) & held).sum())


def _mimi_stream(mimi, params, audio, device, dec_codes=None):
    """Streaming encode of each frame and decode of its codes (or of
    ``dec_codes``) on ``device``; also the quantizer's input per frame."""
    bf = torch.bfloat16
    es = mimi.init_encode_state(1, bf, device)
    ds = mimi.init_decode_state(1, bf, device)
    codes, wavs, q_in = [], [], []
    with recorded_quantizer(mimi, q_in):
        for f, a in enumerate(audio):
            c, es = mimi.encode_step(params, es, a.to(device, bf))
            dc = c if dec_codes is None else dec_codes[f].to(device)
            w, ds = mimi.decode_step(params, ds, dc)
            codes.append(c.cpu())
            wavs.append(w.float().cpu())
    return codes, wavs, [x.cpu() for x in q_in]


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """``torch.backends.cudnn.allow_tf32`` set to ``on`` inside the block
    (as a caller of the port may set it) and restored after it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def compare_mimi(mimi, params):
    """Phase 6: the full-width Mimi, card against CPU on the same weights:
    MIMI_FRAMES frames of streaming encode on distinct audio, then the
    decode of the CPU's codes on both.  The card runs twice: with cuDNN's
    TF32 off, as the script sets it, and with it on, as PyTorch's default
    leaves it for any other caller (the Mimi steps turn it off around
    their convs and give the caller's setting back, ``nn/conv.py``
    ``full_f32_convs``); both are held to the same limits."""
    gen = torch.Generator().manual_seed(SEED + 300)
    fs = mimi.cfg.frame_samples
    audio = [torch.randn((1, fs), generator=gen) * 0.1
             for _ in range(MIMI_FRAMES)]
    params_cpu = tree_to(params, "cpu")
    cpu = _mimi_stream(mimi, params_cpu, audio, "cpu")
    out = _mimi_check(mimi, params, params_cpu, audio, cpu, "TF32 off")
    with cudnn_tf32(True):
        tf32 = _mimi_check(mimi, params, params_cpu, audio, cpu,
                           "TF32 on by the caller")
        if not torch.backends.cudnn.allow_tf32:
            fail("Mimi: the steps did not give the caller's cuDNN TF32 "
                 "setting back")
    del params_cpu
    out["caller_tf32"] = tf32
    return out


def _mimi_check(mimi, params, params_cpu, audio, cpu, label):
    """One card run of ``compare_mimi`` against the CPU's (``cpu``: codes,
    decoded audio and the quantizer's inputs per frame)."""
    cpu_codes, cpu_wavs, q_in = cpu
    codes, wavs, _ = _mimi_stream(mimi, params, audio, DEV, cpu_codes)
    n_q = mimi.cfg.n_q
    decided = agree = 0
    worst = 0.0
    for f in range(MIMI_FRAMES):
        gaps = mimi_chain_gaps(params_cpu, q_in[f], cpu_codes[f], n_q)
        for i, gap in enumerate(gaps):
            if gap <= TOL["mimi_gap"]:
                break             # later codebooks follow another residual
            decided += 1
            agree += int(torch.equal(codes[f][..., i], cpu_codes[f][..., i]))
        if not (torch.isfinite(wavs[f]).all()
                and torch.isfinite(cpu_wavs[f]).all()):
            fail(f"Mimi frame {f}: non-finite decoded audio")
        worst = max(worst, rel_err(wavs[f], cpu_wavs[f]))
    log(f"  Mimi n_q {n_q}, {MIMI_FRAMES} frames, cuDNN {label}: codes "
        f"decided (gap > {TOL['mimi_gap']:g}) {decided}/{MIMI_FRAMES * n_q},"
        f" equal {agree}; decoded audio rel err {worst:.2e} (tol "
        f"{TOL['mimi_audio']:g}), largest |audio| "
        f"{max(float(w.abs().max()) for w in wavs):.3f}")
    if agree != decided or decided < MIMI_FRAMES:
        fail(f"Mimi ({label}): card codes differ from the CPU's where "
             f"decided ({agree}/{decided})")
    if worst > TOL["mimi_audio"]:
        fail(f"Mimi ({label}): decoded audio differs by {worst:.3e} > "
             f"{TOL['mimi_audio']:g}")
    return {"frames": MIMI_FRAMES, "codes_decided": decided,
            "codes_equal": agree, "audio_rel_err": worst,
            "tol_audio": TOL["mimi_audio"], "tol_gap": TOL["mimi_gap"]}


def _sts_inputs(fs, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn((1, fs), generator=gen) * 0.1).to(DEV)
            for _ in range(n)]


def run_sts(cfg, params, mimi, mparams, floor_ms, mega: bool = False,
            per_frame=None, label=None):
    """Phase 7, the main path: STSPipeline.step on the 7B q4_k LM and the
    full Mimi, STS_WARMUP + STS_FRAMES frames at the pipeline's sampling
    defaults, the launch counts zeroed just before and read just after;
    then a second run with the frame split into encode / LM / decode on
    the host clock (a synchronize between them).  With ``mega`` (under
    MOSHI_TPU_MEGAKERNEL=all, set by the caller) the states are made from
    the weights, so the LM takes the flat layout and the megakernels.
    ``per_frame`` and ``label`` name another path's launches (a knob path,
    set by the caller)."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.runtime import pipeline
    pipe = pipeline.STSPipeline(mimi, cfg, device=DEV)
    n = STS_WARMUP + STS_FRAMES
    audio = _sts_inputs(pipe.frame_samples, n, SEED + 5)
    lm_params = params if mega else None
    state = pipe.init_state(1, seed=SEED + 6, lm_params=lm_params)
    if mega and state["lm"]["transformer"]["k"].dim() != 3:
        fail("STS frame: the megakernel state did not take the flat layout")
    label = label or ("STS frame, megakernels" if mega else "STS frame")
    weights = torch.arange(1, cfg.runtime_dep_q + 2, device=DEV)
    sync()
    live = torch.cuda.memory_allocated() if DEV == "cuda" else 0
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with fusion("1"):
        build.COUNTS.clear()                  # the main path starts here
        times, digests = [], []
        for f in range(n):
            t0 = time.perf_counter()
            out, state = pipe.step(mparams, params, state, audio[f])
            toks = torch.cat([out["text"][:, None], out["audio_tokens"]], 1)
            wav = out["audio_out"]
            dg = torch.stack([
                torch.nan_to_num(wav, nan=1.0, posinf=2.0, neginf=-2.0)
                .sum(), (toks * weights).sum().float(),
                torch.isfinite(wav).all().float()]).cpu()   # synchronizes
            dt = time.perf_counter() - t0
            if f >= STS_WARMUP:
                times.append(dt)
            digests.append((float(dg[0]), int(dg[1]), bool(dg[2])))
        counts = dict(build.COUNTS)           # the main path ends here
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    per_frame = per_frame or (mega_launches(cfg) if mega
                              else per_frame_launches(cfg))
    if counts != {k: v * n for k, v in per_frame.items()}:
        fail(f"{label}: launch counts over {n} frames: {counts}, "
             f"expected {per_frame} per frame")
    if not all(d[2] for d in digests):
        fail(f"{label}: non-finite output audio: {digests}")
    if len({d[:2] for d in digests[STS_WARMUP:]}) < 2:
        fail(f"{label}: the outputs do not vary: {digests}")
    ms = sorted(t * 1e3 for t in times)
    mean = sum(ms) / len(ms)

    # the split run: the same step with a synchronize around each part
    split = {"encode": [], "lm": [], "decode": []}

    def timed(part, fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            sync()
            split[part].append((time.perf_counter() - t0) * 1e3)
            return res
        return run

    audio2 = _sts_inputs(pipe.frame_samples, n, SEED + 7)
    state = pipe.init_state(1, seed=SEED + 8, lm_params=lm_params)
    with fusion("1"), \
            swapped(mimi, "encode_step", timed("encode", mimi.encode_step)), \
            swapped(mimi, "decode_step", timed("decode", mimi.decode_step)), \
            swapped(pipeline, "lm_gen_step",
                    timed("lm", pipeline.lm_gen_step)):
        for f in range(n):
            out, state = pipe.step(mparams, params, state, audio2[f])
            out["audio_out"].cpu()
    parts = {k: sum(v[STS_WARMUP:]) / STS_FRAMES for k, v in split.items()}
    log(f"  {label} (7B q4_k LM + Mimi n_q {mimi.cfg.n_q}, bf16), B=1, "
        f"temp {pipe.temp}/{pipe.temp_text}, top-k {pipe.top_k}/"
        f"{pipe.top_k_text}: {STS_FRAMES} timed frames after {STS_WARMUP} "
        f"warm-up; ms/frame mean {mean:.3f} (min {ms[0]:.3f}, max "
        f"{ms[-1]:.3f}) against the {REALTIME_MS:g} ms line; frames/s "
        f"{1e3 / mean:.3f}; LM HBM floor {floor_ms:.3f} ms; peak memory "
        f"{peak / 2 ** 30:.3f} GiB  [{CARD}]")
    log(f"  split run (synchronized between the parts), ms/frame mean: "
        f"encode {parts['encode']:.3f}, LM {parts['lm']:.3f}, decode "
        f"{parts['decode']:.3f}  [{CARD}]")
    log(f"  launches per frame: { {k: v // n for k, v in counts.items()} }")
    return {"warmup": STS_WARMUP, "frames": STS_FRAMES, "ms_per_frame": ms,
            "ms_per_frame_mean": mean, "frames_per_s": 1e3 / mean,
            "realtime_ms": REALTIME_MS, "lm_hbm_floor_ms": floor_ms,
            "peak_memory_bytes": peak, "live_before_bytes": live,
            "launches": counts,
            "launches_per_frame": {k: v // n for k, v in counts.items()},
            "split_ms_per_frame": parts, "split_ms": split,
            "digests": digests}


def run_stt(cfg, params, mimi, mparams, floor_ms, per_frame=None,
            label="STT frame"):
    """Phase 7, the STT path: STTPipeline.step on the dense stt-1b LM and
    the full Mimi at n_q 32, STS_WARMUP + STS_FRAMES frames at the
    pipeline's defaults (text at temp 0), the launch counts zeroed just
    before and read just after; each frame fetches a digest of its text
    token and VAD, and the digests must follow the input.  Then a second
    run split into encode and LM on the host clock.  ``per_frame`` and
    ``label`` name another path's launches (the fp8 rings)."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.runtime import pipeline
    pipe = pipeline.STTPipeline(mimi, cfg, device=DEV)
    n = STS_WARMUP + STS_FRAMES
    audio = _sts_inputs(pipe.frame_samples, n, SEED + 11)
    state = pipe.init_state(1, seed=SEED + 12)
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    build.COUNTS.clear()                      # the STT path starts here
    times, digests = [], []
    for f in range(n):
        t0 = time.perf_counter()
        out, state = pipe.step(mparams, params, state, audio[f])
        dg = torch.stack([out["text"][0].float(), out["vad"][0]]).cpu()
        dt = time.perf_counter() - t0
        if f >= STS_WARMUP:
            times.append(dt)
        digests.append((int(dg[0]), float(dg[1])))
    counts = dict(build.COUNTS)               # the STT path ends here
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    per_frame = per_frame or stt_launches(cfg)
    if counts != {k: v * n for k, v in per_frame.items()}:
        fail(f"{label}: launch counts over {n} frames: {counts}, "
             f"expected {per_frame} per frame and no other kernel")
    if not all(0 <= t < cfg.text_card and 0.0 <= v <= 1.0
               for t, v in digests):
        fail(f"{label}: a text token or VAD out of range: {digests}")
    if len({d[0] for d in digests[STS_WARMUP:]}) < 2:
        fail(f"{label}: the text tokens do not follow the input: "
             f"{digests}")
    ms = sorted(t * 1e3 for t in times)
    mean = sum(ms) / len(ms)

    split = {"encode": [], "lm": []}

    def timed(part, fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            sync()
            split[part].append((time.perf_counter() - t0) * 1e3)
            return res
        return run

    audio2 = _sts_inputs(pipe.frame_samples, n, SEED + 13)
    state = pipe.init_state(1, seed=SEED + 14)
    with swapped(mimi, "encode_step", timed("encode", mimi.encode_step)), \
            swapped(pipeline, "lm_gen_step",
                    timed("lm", pipeline.lm_gen_step)):
        for f in range(n):
            out, state = pipe.step(mparams, params, state, audio2[f])
            out["text"].cpu()
    parts = {k: sum(v[STS_WARMUP:]) / STS_FRAMES for k, v in split.items()}
    log(f"  {label} (dense stt-1b LM + Mimi n_q {mimi.cfg.n_q} encode, "
        f"bf16), B=1, text temp {pipe.temp_text}: {STS_FRAMES} timed frames "
        f"after {STS_WARMUP} warm-up; ms/frame mean {mean:.3f} (min "
        f"{ms[0]:.3f}, max {ms[-1]:.3f}) against the {REALTIME_MS:g} ms "
        f"line; frames/s {1e3 / mean:.3f}; LM HBM floor {floor_ms:.3f} ms; "
        f"peak memory {peak / 2 ** 30:.3f} GiB  [{CARD}]")
    log(f"  split run (synchronized between the parts), ms/frame mean: "
        f"encode {parts['encode']:.3f}, LM {parts['lm']:.3f}  [{CARD}]")
    log(f"  launches per frame: { {k: v // n for k, v in counts.items()} }")
    log(f"  digests (text, VAD): {digests}")
    return {"warmup": STS_WARMUP, "frames": STS_FRAMES, "ms_per_frame": ms,
            "ms_per_frame_mean": mean, "frames_per_s": 1e3 / mean,
            "realtime_ms": REALTIME_MS, "lm_hbm_floor_ms": floor_ms,
            "peak_memory_bytes": peak, "launches": counts,
            "launches_per_frame": {k: v // n for k, v in counts.items()},
            "split_ms_per_frame": parts, "split_ms": split,
            "digests": digests}


def pool_launches(cfg, params):
    """Kernel launches one frame makes at B > 1, where no product takes
    the int8 kernels and the fusion is off (it needs one row): K6 for the
    text head and the depformer in-projection, K8 for each GLU of a q4_k
    or q8_0 linear_in (a q4_0 one takes K2 over its 2H rows), K2 for every
    other projection and the depformer's logits."""
    from moshi_tpu_torch.quant.matmul import GLU_FORMATS
    t, d = cfg.num_layers, cfg.depformer_layers * cfg.dep_q
    counts = {"qmatmul": 2, "glu_matvec": 0,
              "dequant_matvec": 3 * t + 3 * d + cfg.dep_q,
              "decode_attention": t + d, "ring_write": 1}
    for w, n in ((params["transformer"]["layers"]["gating"]["linear_in"]
                  ["weight"], t),
                 (params["depformer"]["layers"]["gating"]["linear_in"]
                  ["weight"], d)):
        counts["glu_matvec" if w.fmt in GLU_FORMATS else "dequant_matvec"] \
            += n
    return {k: v for k, v in counts.items() if v}


def _pool_schedule(batch: int, n: int):
    """(tick, action, session) of the pool run: ``batch`` - 2 sessions
    attach before tick 0 and one more before each of ticks 1 and 2, so
    that the sessions differ in age; before the middle timed tick session
    s3 leaves and r3 takes its slot, from a fresh state."""
    sched = [(0, "attach", f"s{i}") for i in range(batch - 2)]
    sched += [(1, "attach", f"s{batch - 2}"), (2, "attach", f"s{batch - 1}")]
    mid = POOL_WARMUP + POOL_TICKS // 2
    sched += [(mid, "detach", "s3"), (mid, "attach", "r3")]
    return [e for e in sched if e[0] < n]


def run_pool(cfg, params, mimi, mparams, batch: int, per_tick=None,
             label="SessionPool"):
    """Phase 7, the batched path: ``SessionPool.tick`` with ``batch``
    sessions of the 7B q4_k LM and the full Mimi at the pipeline's
    sampling defaults, POOL_WARMUP warm-up and POOL_TICKS timed ticks,
    each session with its own audio every tick and attaching at its own
    tick (``_pool_schedule``), a detach and a re-attach in the middle; the
    launch counts zeroed just before the first tick and read after the
    last.  Each tick brings every session's output to the host (the pool's
    one copy); a digest of each must follow the input.  The peak device
    memory over the run, against the live memory before the pool, gives
    the port's KV transient factor.  ``per_tick`` and ``label`` name
    another path's launches (the fp8 rings).  Returns (report, pool,
    inputs)."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.runtime import memory
    from moshi_tpu_torch.runtime.pipeline import STSPipeline
    from moshi_tpu_torch.runtime.serving import SessionPool
    pipe = STSPipeline(mimi, cfg, device=DEV)
    fs = pipe.frame_samples
    n = POOL_WARMUP + POOL_TICKS
    sched = _pool_schedule(batch, n)
    gen = torch.Generator().manual_seed(SEED + 16)
    audio = {sid: [torch.randn(fs, generator=gen) * 0.1 for _ in range(n)]
             for _, act, sid in sched if act == "attach"}
    sync()
    before = torch.cuda.memory_allocated() if DEV == "cuda" else 0
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pool = SessionPool(pipe, mparams, params, batch=batch, seed=SEED + 17)
    times, digests, age = [], [], {}
    build.COUNTS.clear()                      # the batched path starts here
    for t in range(n):
        for tt, act, sid in sched:
            if tt == t:
                if act == "attach":
                    pool.attach(sid)
                    age[sid] = 0
                else:
                    pool.detach(sid)
        frames = {sid: audio[sid][age[sid]] for sid in pool._by_session}
        t0 = time.perf_counter()
        outs = pool.tick(frames)              # one copy to the host
        dt = time.perf_counter() - t0
        if t >= POOL_WARMUP:
            times.append(dt)
        for sid in frames:
            age[sid] += 1
        digests.append({sid: (float(o["audio_out"].sum()), o["text"],
                              o["valid"]) for sid, o in outs.items()})
    counts = dict(build.COUNTS)               # the batched path ends here
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    per_tick = per_tick or pool_launches(cfg, params)
    if counts != {k: v * n for k, v in per_tick.items()}:
        fail(f"{label} B={batch}: launch counts over {n} ticks: {counts}, "
             f"expected {per_tick} per tick and no other kernel")
    for t, dg in enumerate(digests):
        if not all(a == a and abs(a) != float("inf")
                   for a, _, _ in dg.values()):
            fail(f"pool tick {t}: non-finite output audio: {dg}")
        if not all(-2 <= txt < cfg.text_card for _, txt, _ in dg.values()):
            fail(f"pool tick {t}: a text token out of range: {dg}")
        if t >= POOL_WARMUP and len({a for a, _, _ in dg.values()}) < 2:
            fail(f"pool tick {t}: the sessions' outputs do not differ: {dg}")
    for sid in audio:
        seen = [dg[sid][0] for dg in digests[POOL_WARMUP:] if sid in dg]
        if len(seen) > 2 and len(set(seen)) < 2:
            fail(f"pool session {sid}: its output does not follow its "
                 f"input: {seen}")
    mid = POOL_WARMUP + POOL_TICKS // 2
    lead = cfg.max_delay + 1
    if digests[mid]["r3"][2] or not all(
            dg[2] for sid, dg in digests[mid].items()
            if sid != "r3" and age[sid] > lead + (n - mid)):
        fail(f"pool tick {mid}: the re-attached slot must restart in its "
             f"lead-in and the older sessions stay valid: {digests[mid]}")
    ms = sorted(dt * 1e3 for dt in times)
    mean = sum(ms) / len(ms)
    kv = memory.kv_bytes_per_session(cfg)
    factor = (peak - before) / (batch * kv) if DEV == "cuda" else 0.0
    log(f"  {label} B={batch} (7B q4_k LM + Mimi n_q {mimi.cfg.n_q}, "
        f"bf16), temp {pipe.temp}/{pipe.temp_text}: {POOL_TICKS} timed ticks "
        f"after {POOL_WARMUP} warm-up; ms/tick mean {mean:.3f} (min "
        f"{ms[0]:.3f}, max {ms[-1]:.3f}) against the {REALTIME_MS:g} ms line;"
        f" session-frames/s {batch * 1e3 / mean:.3f}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB ({(peak - before) / 2 ** 30:.3f} GiB over "
        f"the {before / 2 ** 30:.3f} GiB live before the pool; KV rings "
        f"{batch * kv / 2 ** 30:.3f} GiB; factor {factor:.4f})  [{CARD}]")
    log(f"  launches per tick: { {k: v // n for k, v in counts.items()} }")
    log(f"  tick {mid} (s3 left, r3 attached): {digests[mid]}")
    report = {"batch": batch, "warmup": POOL_WARMUP, "ticks": POOL_TICKS,
              "ms_per_tick": ms, "ms_per_tick_mean": mean,
              "session_frames_per_s": batch * 1e3 / mean,
              "realtime_ms": REALTIME_MS, "peak_memory_bytes": peak,
              "live_before_bytes": before, "kv_bytes_per_session": kv,
              "kv_transient": factor, "launches": counts,
              "launches_per_tick": {k: v // n for k, v in counts.items()},
              "schedule": sched, "digests": digests}
    return report, pool, audio


def profile_pool(pool, audio):
    """One pool tick (all its sessions attached) under the profiler."""
    sids = list(pool._by_session)

    def run_frame(f):
        pool.tick({sid: audio[sid][f % len(audio[sid])] for sid in sids
                   if sid in audio})

    return _profile(f"SessionPool tick, B={pool.batch}", run_frame, n=1)


def hbm_floor_ms(rows, temporal_attention, temporal_layers,
                 fused: bool = True):
    """Bytes one frame must move over the HBM rate: every matvec's
    weights, the depformer's attention and the ring write, with the
    temporal attention of the check labelled ``temporal_attention``."""
    key = "calls_per_frame" if fused else "calls_per_frame_unfused"
    total = 0.0
    for r in rows:
        if r["kernel"] == "decode_attention" and r["shape"].startswith(
                "temporal"):
            if r["shape"] == temporal_attention:
                total += r["bytes"] * temporal_layers
        else:
            total += r["bytes"] * r.get(key, r["calls_per_frame"])
    return total / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# the TTS paths: phases 4, 7 and 8
# ---------------------------------------------------------------------------

def tts_voice(cfg, seed: int):
    """(condition_sum [1, dim], condition_cross [1, 5 * TTS_S, dim]) on the
    card: ``voice_condition`` on TTS_S synthetic speaker rows of width
    TTS_DW, with synthetic conditioners (``synth_conditioners``)."""
    from moshi_tpu_torch.models.tts import voice_condition
    from moshi_tpu_torch.runtime.synth import synth_conditioners
    cond = synth_conditioners(cfg.dim, wav_dim=TTS_DW, device=DEV, seed=seed)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    wavs = torch.randn((TTS_S, TTS_DW), generator=gen, device=DEV)
    return voice_condition(cond, wavs)


@contextlib.contextmanager
def _taped(tape, forced=None):
    """Inside the block every ``sample_token`` call appends its logits (on
    the host) and its token to ``tape``, and every ``lm_text_step`` (the
    pipelines' and the LM module's, which ``lm_gen_step`` calls) its
    transformer_out; with ``forced`` (another run's tape) each call
    returns that run's token instead, so that this run follows it token
    for token."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime import pipeline
    sample, text_step = lm.sample_token, lm.lm_text_step
    tape.setdefault("logits", [])
    tape.setdefault("tokens", [])
    tape.setdefault("h", [])

    def rec_sample(logits, *a, **kw):
        tok = sample(logits, *a, **kw)
        if forced is not None:
            tok = forced["tokens"][len(tape["tokens"])].to(tok.device)
        tape["logits"].append(logits.float().cpu())
        tape["tokens"].append(tok.cpu())
        return tok

    def rec_text(*a, **kw):
        res = text_step(*a, **kw)
        tape["h"].append(res[1].float().cpu())
        return res

    with swapped(lm, "sample_token", rec_sample), \
            swapped(lm, "lm_text_step", rec_text), \
            swapped(pipeline, "lm_text_step", rec_text):
        yield tape


def _tts_lm_frames(cfg, params, voice, n, device, forced=None, state=None):
    """``n`` frames of the TTS LM at B = 1 and temp 0 from a fresh state on
    ``device`` (or from a copy of ``state``): ``lm_text_step`` with the
    voice's condition_sum and every layer's cross K/V, then
    ``lm_audio_step``.  Returns the tape (per sample_token call: the text
    head's, then dep_q depformer steps')."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.nn.transformer import transformer_cross_kv
    csum, cross = (v.to(device) for v in voice)
    ckv = transformer_cross_kv(cfg.transformer, params["transformer"], cross)
    state = (lm.init_gen_state(cfg, 1, device=device) if state is None
             else _state_copy(state, device))
    tape = {}
    with _taped(tape, forced):
        for _ in range(n):
            tok, h, state = lm.lm_text_step(cfg, params, state,
                                            condition_sum=csum, cross_kv=ckv,
                                            temp_text=0.0)
            out, state = lm.lm_audio_step(cfg, params, state, tok, h,
                                          temp=0.0)
    return tape


def _tts_compare(card, cpu, tol, tol_dep, card_size):
    """Card against CPU tapes of the same run (the CPU forced to the card's
    tokens): the largest relative error of transformer_out, of the text
    logits and of the depformer's logits (rows live on the card only),
    and the decided tokens (the CPU's top-1/top-2 gap above the limit)
    that agree: the card's token must be the CPU's argmax there."""
    worst = {"transformer_out": 0.0, "logits": 0.0, "dep_logits": 0.0,
             "vad": None}
    for a, c in zip(card["h"], cpu["h"]):
        worst["transformer_out"] = max(worst["transformer_out"],
                                       rel_err(a, c))
    agree = total = 0
    for lg_a, lg_c, tok in zip(card["logits"], cpu["logits"],
                               card["tokens"]):
        key = "dep_logits" if lg_c.shape[-1] == card_size else "logits"
        limit = tol_dep if key == "dep_logits" else tol
        for r in range(lg_c.shape[0]):
            worst[key] = max(worst[key], rel_err(lg_a[r], lg_c[r]))
        ok = _gap(lg_c) > limit
        agree += int((tok.reshape(-1) == lg_c.argmax(-1))[ok].sum())
        total += int(ok.sum())
    passes = (max(worst["transformer_out"], worst["logits"]) <= tol
              and worst["dep_logits"] <= tol_dep and agree == total)
    return dict(worst, tokens_agree=agree, tokens_total=total, passes=passes)


@reused_plain_weights()
def compare_tts_two_layers():
    """Phase 4 (TTS): 2 layers of the cross-attention TTS class at B = 1,
    card against CPU on the same q4_k weights and synthetic voice, for
    SEEDS_TTS seeds of FRAMES_TTS_2L frames from a session past its first
    ring (``long_session_state``: every temporal attention reads its whole
    window), the CPU following the card's tokens, with the B = 1 controls
    on the first seed (K5's moves only the depformer's logits)."""
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = tts_config(2)
    tol, tol_dep = TOL["tts_2l"], TOL["tts_2l_dep"]
    readings, controls = [], {}
    with fusion("1"):
        for s in range(SEEDS_TTS):
            seed = SEED + 40 + s
            params = synth_lm_params(cfg, "q4_k", device=DEV, seed=seed)
            params_cpu = tree_to(params, "cpu")
            voice = tts_voice(cfg, seed)
            state = long_session_state(
                cfg, torch.Generator(device=DEV).manual_seed(seed + 100))
            card = _tts_lm_frames(cfg, params, voice, FRAMES_TTS_2L, DEV,
                                  state=state)
            cpu = _tts_lm_frames(cfg, params_cpu, voice, FRAMES_TTS_2L,
                                 "cpu", forced=card, state=state)
            r = dict(_tts_compare(card, cpu, tol, tol_dep, cfg.card),
                     seed=seed)
            readings.append(r)
            log(f"  TTS 2 layers, seed {seed}: {_show(r)}")
            if s == 0:
                for name, ctx in _frame_controls("1"):
                    with ctx():
                        ctl = _tts_lm_frames(cfg, params_cpu, voice,
                                             FRAMES_TTS_2L, "cpu",
                                             forced=card, state=state)
                    controls[name] = _tts_compare(ctl, cpu, tol, tol_dep,
                                                  cfg.card)
                    log(f"  TTS 2 layers, control ({name}) against the "
                        f"CPU: {_show(controls[name])}")
            del params, params_cpu, state
    for r in readings:
        if not r["passes"]:
            fail(f"TTS 2-layer frame, seed {r['seed']}: card and CPU differ "
                 f"beyond {tol:g} (depformer {tol_dep:g}) or in a decided "
                 f"token: {_show(r)}")
    for name, c in controls.items():
        if c["passes"]:
            fail(f"TTS 2-layer frame: the control ({name}) passes the "
                 f"check: it cannot tell that rounding apart")
    return {"frames": FRAMES_TTS_2L, "readings": readings,
            "controls": controls, "tol_rel": tol, "tol_dep_rel": tol_dep,
            "voice": {"S": TTS_S, "Dw": TTS_DW}}


@reused_plain_weights()
def compare_tts_full_depth(cfg, params):
    """Phase 4 (TTS): all 16 layers at B = 1, card against CPU, for
    FRAMES_TTS_FULL frames of a fresh session with a synthetic voice."""
    tol, tol_dep = TOL["tts_full"], TOL["tts_full_dep"]
    voice = tts_voice(cfg, SEED + 45)
    with fusion("1"):
        card = _tts_lm_frames(cfg, params, voice, FRAMES_TTS_FULL, DEV)
        params_cpu = tree_to(params, "cpu")
        cpu = _tts_lm_frames(cfg, params_cpu, voice, FRAMES_TTS_FULL, "cpu",
                             forced=card)
    del params_cpu
    r = _tts_compare(card, cpu, tol, tol_dep, cfg.card)
    log(f"  TTS {cfg.num_layers} layers, {FRAMES_TTS_FULL} frames: "
        f"{_show(r)}")
    if not r["passes"]:
        fail(f"TTS full-depth frame: card and CPU differ beyond {tol:g} "
             f"(depformer {tol_dep:g}) or in a decided token: {_show(r)}")
    return dict(r, frames=FRAMES_TTS_FULL, tol_rel=tol, tol_dep_rel=tol_dep)


def tts_scripts(cfg, n: int):
    """``n`` scripts of different lengths (1 to about 3n words of random
    text token ids), as lists of Entry."""
    from moshi_tpu_torch.models.state_machine import Entry
    gen = torch.Generator().manual_seed(SEED + 50)
    scripts = []
    for i in range(n):
        words = 1 + 3 * i
        scripts.append([Entry(torch.randint(
            4, cfg.text_card, (1 + int(torch.randint(0, 3, (1,),
                                                     generator=gen)),),
            generator=gen).tolist(), f"w{j}", 1) for j in range(words)])
    return scripts


def _tts_pool(cfg, params, mimi, mparams, batch, device, seed):
    from moshi_tpu_torch.models.state_machine import StateMachine
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    from moshi_tpu_torch.runtime.serving import TTSSessionPool
    pipe = TTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0, device=device)
    machine = StateMachine(text_card=cfg.text_card + 1)
    return TTSSessionPool(pipe, machine, mparams, params, batch=batch,
                          max_tokens=TTS_MAX_TOKENS, max_entries=TTS_MAX_TOKENS,
                          seed=seed)


def _drive_tts_pool(pool, scripts, n, tape=None, forced=None):
    """``n`` ticks with session i attaching at tick i // 3 (so that they
    differ in age); per tick the sessions' results."""
    ticks = []
    ctx = (_taped(tape, forced) if tape is not None
           else contextlib.nullcontext())
    with ctx:
        for t in range(n):
            for i, sc in enumerate(scripts):
                if i // 3 == t:
                    pool.attach(f"s{i}", sc)
            ticks.append(pool.tick())
    return ticks


@reused_plain_weights()
def compare_tts_pool_two_layers(mimi, mparams, batch: int):
    """Phase 4 (TTS pool): 2 layers of the TTS class at B = ``batch``
    through ``TTSSessionPool`` (the device FSM, no voice, as the pool
    serves), card against CPU, slots attaching at different ticks, the CPU
    following the card's tokens; then the B > 1 controls on the CPU."""
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = tts_config(2)
    tol, tol_dep = TOL["tts_pool_2l"], TOL["tts_pool_2l_dep"]
    params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 46)
    params_cpu = tree_to(params, "cpu")
    mparams_cpu = tree_to(mparams, "cpu")
    scripts = tts_scripts(cfg, batch)
    card = {}
    cticks = _drive_tts_pool(_tts_pool(cfg, params, mimi, mparams, batch,
                                       DEV, SEED), scripts,
                             TTS_POOL_TICKS_2L, card)
    cpu = {}
    pticks = _drive_tts_pool(_tts_pool(cfg, params_cpu, mimi, mparams_cpu,
                                       batch, "cpu", SEED), scripts,
                             TTS_POOL_TICKS_2L, cpu, forced=card)
    r = _tts_compare(card, cpu, tol, tol_dep, cfg.card)
    # the decoded audio (bf16 Mimi), logged: phase 6 holds Mimi
    audio = [rel_err(torch.as_tensor(ct[sid]["audio_out"]),
                     torch.as_tensor(pt[sid]["audio_out"]))
             for ct, pt in zip(cticks, pticks) for sid in ct
             if pt[sid]["valid"]]
    log(f"  TTS pool B={batch}, 2 layers, {TTS_POOL_TICKS_2L} ticks: "
        f"{_show(r)}; valid audio frames {len(audio)}, largest error "
        f"{max(audio, default=0.0):.2e}")
    controls = {}
    for name, ctx in _pool_controls():
        with ctx():
            ctl = {}
            _drive_tts_pool(_tts_pool(cfg, params_cpu, mimi, mparams_cpu,
                                      batch, "cpu", SEED), scripts,
                            TTS_POOL_TICKS_2L, ctl, forced=card)
        controls[name] = _tts_compare(ctl, cpu, tol, tol_dep, cfg.card)
        log(f"  TTS pool B={batch}, control ({name}) against the CPU: "
            f"{_show(controls[name])}")
    del params, params_cpu, mparams_cpu
    if not r["passes"]:
        fail(f"TTS pool B={batch}, 2 layers: card and CPU differ beyond "
             f"{tol:g} (depformer {tol_dep:g}) or in a decided token: "
             f"{_show(r)}")
    for name, c in controls.items():
        if c["passes"]:
            fail(f"TTS pool B={batch}, 2 layers: the control ({name}) "
                 f"passes the check: it cannot tell that rounding apart")
    return dict(r, batch=batch, ticks=TTS_POOL_TICKS_2L, controls=controls,
                tol_rel=tol, tol_dep_rel=tol_dep, audio_rel_err=audio)


def tts_launches(cfg, bf16: bool = False):
    """Kernel launches one TTS frame makes at B = 1.  q4_k: in each
    temporal layer (the generic path) K1 takes the in_proj, out_proj, the
    cross-attention's query projection and out_proj, the GLU and
    linear_out (one launch each), K11 writes k and v (one launch) and K9
    attends; K1 the text head, the depformer in-projection and each
    step's logits; per depformer step and layer K1 the in_proj, K3, K5 and
    K2 (the q4_0 linear_out).  Dense bf16: K11 and K9 in each temporal
    layer and in each depformer step and layer (its generic form), the
    products on cuBLAS."""
    t = cfg.num_layers
    d = cfg.depformer_layers * cfg.runtime_dep_q
    if bf16:
        return {"ring_write4": t + d, "decode_attention4": t + d}
    return {"int8_matvec": 6 * t + 1 + 1 + d + cfg.runtime_dep_q,
            "attn_ffn_fused": d, "dequant_matvec": d,
            "decode_attention": d, "decode_attention4": t,
            "ring_write4": t}


def tts_pool_launches(cfg):
    """Kernel launches one pool tick makes at B > 1: per temporal layer K6
    takes the in_proj, out_proj and linear_out, K7 the GLU, K11 (k and v
    in one launch) and K9 the attention (the pool passes no cross K/V);
    K6 the text head and the depformer in-projection; per depformer step
    and layer K2 the in_proj, out_proj and linear_out, K3 and K8; K2 each
    step's logits."""
    t = cfg.num_layers
    d = cfg.depformer_layers * cfg.runtime_dep_q
    return {"qmatmul": 3 * t + 2, "glu_matmul": t, "decode_attention4": t,
            "ring_write4": t, "dequant_matvec": 3 * d + cfg.runtime_dep_q,
            "decode_attention": d, "glu_matvec": d}


def _leaf_bytes(w) -> int:
    """Bytes the frame reads of a whole (stacked) weight: for a
    QuantTensor every row's packed values and bf16 scales."""
    from moshi_tpu_torch.quant.formats import QuantTensor
    if isinstance(w, QuantTensor):
        return _qt_layer_bytes(w, w.q.numel() // w.q.shape[-1])
    return w.numel() * w.element_size()


def tts_floor_ms(cfg, params, valid: float, batch: int = 1):
    """Bytes one TTS frame (or pool tick) must move over the HBM rate:
    every temporal and depformer weight it reads once, the text head, the
    KV rings' ``valid`` positions per session (and at B = 1 the cross
    K/V), read once."""
    lay = params["transformer"]["layers"]
    dep = params["depformer"]
    total = sum(_leaf_bytes(lay[a][b]["weight"]) for a, b in (
        ("self_attn", "in_proj"), ("self_attn", "out_proj"),
        ("gating", "linear_in"), ("gating", "linear_out")))
    if batch == 1:
        total += sum(_leaf_bytes(lay["cross_attention"][b]["weight"])
                     for b in ("in_proj", "out_proj"))
        total += 2 * cfg.num_layers * 5 * TTS_S * cfg.dim * 2
    total += _leaf_bytes(params["text_linear"]["weight"])
    total += _leaf_bytes(dep["in"]["weight"])
    total += sum(_leaf_bytes(dep["layers"][a][b]["weight"]) for a, b in (
        ("self_attn", "in_proj"), ("self_attn", "out_proj"),
        ("gating", "linear_in"), ("gating", "linear_out")))
    total += _leaf_bytes(dep["linears"]["weight"])
    total += batch * 2 * cfg.num_layers * valid * cfg.dim * 2
    return total / HBM_BYTES_PER_S * 1e3


def run_tts(cfg, params, mimi, mparams, floor_ms, bf16: bool = False,
            warmup=None, frames=None, per_frame=None, second_ahead: int = 0,
            label=None):
    """Phase 7, the B = 1 TTS frame: ``TTSPipeline.step_device`` (the
    device FSM, muxing its second stream ``second_ahead`` words ahead
    where given) with the voice's condition_sum and cross K/V, at the
    pipeline's sampling defaults, TTS_WARMUP + TTS_FRAMES frames (in bf16:
    TTS_BF16_WARMUP + TTS_BF16_FRAMES; else ``warmup`` + ``frames``), each
    with a digest of its audio and tokens fetched to the host; the launch
    counts zeroed just before the first frame and read after the last,
    and asserted (against ``per_frame`` where given)."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models.device_machine import (compile_script,
                                                       init_device_state)
    from moshi_tpu_torch.models.state_machine import StateMachine
    from moshi_tpu_torch.nn.transformer import transformer_cross_kv
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    warm, frames = ((TTS_BF16_WARMUP, TTS_BF16_FRAMES) if bf16
                    else (warmup or TTS_WARMUP, frames or TTS_FRAMES))
    n = warm + frames
    pipe = TTSPipeline(mimi, cfg, device=DEV)
    dm = pipe.enable_device_fsm(StateMachine(
        text_card=cfg.text_card + 1, second_stream_ahead=second_ahead))
    script = compile_script(tts_scripts(cfg, 4)[3:], dm, device=DEV)
    csum, cross = tts_voice(cfg, SEED + 47)
    ckv = transformer_cross_kv(cfg.transformer, params["transformer"], cross)
    state = pipe.init_state(1, seed=SEED + 48)
    mstate = init_device_state(dm, script)
    weights = torch.arange(1, cfg.runtime_dep_q + 2, device=DEV)
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with fusion("1"):
        build.COUNTS.clear()                  # the TTS path starts here
        times, digests = [], []
        for f in range(n):
            t0 = time.perf_counter()
            out, state, mstate = pipe.step_device(
                mparams, params, state, mstate, script, condition_sum=csum,
                cross_kv=ckv)
            toks = torch.cat([out["machine_text"][:, None],
                              out["audio_tokens"]], 1)
            wav = out["audio_out"]
            dg = torch.stack([
                torch.nan_to_num(wav, nan=1.0, posinf=2.0, neginf=-2.0)
                .sum(), (toks * weights).sum().float(),
                torch.isfinite(wav).all().float()]).cpu()   # synchronizes
            dt = time.perf_counter() - t0
            if f >= warm:
                times.append(dt)
            digests.append((float(dg[0]), int(dg[1]), bool(dg[2])))
        counts = dict(build.COUNTS)           # the TTS path ends here
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    label = label or ("bf16" if bf16 else "q4_k")
    per_frame = per_frame or tts_launches(cfg, bf16)
    if counts != {k: v * n for k, v in per_frame.items()}:
        fail(f"TTS frame ({label}): launch counts over {n} frames: {counts}, "
             f"expected {per_frame} per frame")
    if not all(d[2] for d in digests):
        fail(f"TTS frame ({label}): non-finite output audio: {digests}")
    if len({d[:2] for d in digests[warm:]}) < 2:
        fail(f"TTS frame ({label}): the outputs do not vary: {digests}")
    ms = sorted(t * 1e3 for t in times)
    mean = sum(ms) / len(ms)
    log(f"  TTS frame ({label} LM with a voice, Mimi n_q {mimi.cfg.n_q} "
        f"decode), B=1, temp {pipe.temp}/{pipe.temp_text}: {frames} timed "
        f"frames after {warm} warm-up; ms/frame mean {mean:.3f} (min "
        f"{ms[0]:.3f}, max {ms[-1]:.3f}) against the {REALTIME_MS:g} ms "
        f"line; frames/s {1e3 / mean:.3f}; LM HBM floor {floor_ms:.3f} ms; "
        f"peak memory {peak / 2 ** 30:.3f} GiB  [{CARD}]")
    log(f"  launches per frame: { {k: v // n for k, v in counts.items()} }")
    return {"warmup": warm, "frames": frames, "ms_per_frame": ms,
            "ms_per_frame_mean": mean, "frames_per_s": 1e3 / mean,
            "realtime_ms": REALTIME_MS, "lm_hbm_floor_ms": floor_ms,
            "peak_memory_bytes": peak, "launches": counts,
            "launches_per_frame": {k: v // n for k, v in counts.items()},
            "digests": digests}


def run_tts_pool(cfg, params, mimi, mparams, batch: int):
    """Phase 7, the batched TTS path: ``TTSSessionPool`` with ``batch``
    slots of the q4_k TTS class at the pipeline's sampling defaults,
    scripts of different lengths attaching three per tick, the shortest
    one draining and detaching mid-run and a new session taking its slot
    on the next tick; TTS_POOL_WARMUP + TTS_POOL_TICKS ticks, then one
    ``tick_chunk(TTS_CHUNK)``; the launch counts zeroed just before the
    first tick and asserted per frame after the chunk.  Each tick brings
    every session's output to the host in one copy.  Returns (report,
    pool)."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models.state_machine import StateMachine
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    from moshi_tpu_torch.runtime.serving import TTSSessionPool
    pipe = TTSPipeline(mimi, cfg, device=DEV)
    scripts = tts_scripts(cfg, batch)
    extra = tts_scripts(cfg, 2)[1]
    n = TTS_POOL_WARMUP + TTS_POOL_TICKS
    sync()
    before = torch.cuda.memory_allocated() if DEV == "cuda" else 0
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pool = TTSSessionPool(pipe, StateMachine(text_card=cfg.text_card + 1),
                          mparams, params, batch=batch,
                          max_tokens=TTS_MAX_TOKENS,
                          max_entries=TTS_MAX_TOKENS, seed=SEED + 49)
    times, digests, events = [], [], []
    build.COUNTS.clear()                      # the batched TTS path starts
    for t in range(n):
        for i, sc in enumerate(scripts):
            if i // 3 == t:
                pool.attach(f"s{i}", sc)
        if events and events[-1][1] == "done" and "r0" not in \
                pool._by_session and not any(e[2] == "r0" for e in events):
            pool.attach("r0", extra)
            events.append((t, "attach", "r0"))
        t0 = time.perf_counter()
        outs = pool.tick()                    # one copy to the host
        dt = time.perf_counter() - t0
        if t >= TTS_POOL_WARMUP:
            times.append(dt)
        for sid, o in outs.items():
            if o["done"]:
                events.append((t, "done", sid))
        digests.append({sid: (float(o["audio_out"].sum()), o["valid"],
                              o["done"]) for sid, o in outs.items()})
    chunk = pool.tick_chunk(TTS_CHUNK)
    counts = dict(build.COUNTS)               # the batched TTS path ends
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    per_tick = tts_pool_launches(cfg)
    frames = n + TTS_CHUNK
    if counts != {k: v * frames for k, v in per_tick.items()}:
        fail(f"TTS pool B={batch}: launch counts over {frames} frames: "
             f"{counts}, expected {per_tick} per tick and no other kernel")
    done = [e for e in events if e[1] == "done"]
    if not done or not any(e[1] == "attach" for e in events):
        fail(f"TTS pool B={batch}: no session drained and was replaced "
             f"mid-run: {events}")
    for t, dg in enumerate(digests):
        if not all(a == a and abs(a) != float("inf")
                   for a, _, _ in dg.values()):
            fail(f"TTS pool tick {t}: non-finite output audio: {dg}")
    if not any(v for dg in digests for _, v, _ in dg.values()):
        fail(f"TTS pool B={batch}: no valid frame in {n} ticks")
    if not all(len(r["valid"]) <= TTS_CHUNK for r in chunk.values()):
        fail(f"TTS pool B={batch}: tick_chunk returned more frames than "
             f"asked")
    ms = sorted(dt * 1e3 for dt in times)
    mean = sum(ms) / len(ms)
    log(f"  TTSSessionPool B={batch} (q4_k TTS LM + Mimi n_q "
        f"{mimi.cfg.n_q}), temp {pipe.temp}/{pipe.temp_text}: "
        f"{TTS_POOL_TICKS} timed ticks after {TTS_POOL_WARMUP} warm-up; "
        f"ms/tick mean {mean:.3f} (min {ms[0]:.3f}, max {ms[-1]:.3f}) "
        f"against the {REALTIME_MS:g} ms line; session-frames/s "
        f"{batch * 1e3 / mean:.3f}; peak memory {peak / 2 ** 30:.3f} GiB "
        f"({(peak - before) / 2 ** 30:.3f} GiB over the "
        f"{before / 2 ** 30:.3f} GiB live before the pool)  [{CARD}]")
    log(f"  launches per tick: { {k: v // frames for k, v in counts.items()} }"
        f"; sessions done and replaced: {events}")
    report = {"batch": batch, "warmup": TTS_POOL_WARMUP,
              "ticks": TTS_POOL_TICKS, "chunk": TTS_CHUNK,
              "ms_per_tick": ms, "ms_per_tick_mean": mean,
              "session_frames_per_s": batch * 1e3 / mean,
              "realtime_ms": REALTIME_MS, "peak_memory_bytes": peak,
              "live_before_bytes": before, "launches": counts,
              "launches_per_tick": {k: v // frames
                                    for k, v in counts.items()},
              "events": events, "digests": digests}
    return report, pool


def profile_tts(cfg, params, mimi, mparams, bf16: bool = False):
    """One TTS frame (step_device at B = 1 with a voice; q4_k, or the
    dense bf16 weights ``params`` with ``bf16``) under the profiler, the
    kernels around its ring writes held."""
    from moshi_tpu_torch.models.device_machine import (compile_script,
                                                       init_device_state)
    from moshi_tpu_torch.models.state_machine import StateMachine
    from moshi_tpu_torch.nn.transformer import transformer_cross_kv
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    pipe = TTSPipeline(mimi, cfg, device=DEV)
    dm = pipe.enable_device_fsm(StateMachine(text_card=cfg.text_card + 1))
    script = compile_script(tts_scripts(cfg, 4)[3:], dm, device=DEV)
    csum, cross = tts_voice(cfg, SEED + 47)
    ckv = transformer_cross_kv(cfg.transformer, params["transformer"], cross)
    box = {"state": pipe.init_state(1, seed=SEED + 51),
           "mstate": init_device_state(dm, script)}

    def run_frame(f):
        out, box["state"], box["mstate"] = pipe.step_device(
            mparams, params, box["state"], box["mstate"], script,
            condition_sum=csum, cross_kv=ckv)
        out["audio_out"].cpu()

    with fusion("1"):
        m = cfg.transformer.mha
        return _profile(f"TTS frame ({'bf16' if bf16 else 'q4_k'}, B=1)",
                        run_frame, n=1,
                        ring_writes=tts_launches(cfg, bf16)["ring_write4"],
                        rope=(1, m.num_heads, m.head_dim))


def profile_tts_pool(pool):
    """One TTS pool tick under the profiler, the kernels around its ring
    writes held."""
    cfg = pool.pipe.lm_cfg
    m = cfg.transformer.mha
    return _profile(f"TTSSessionPool tick, B={pool.batch}",
                    lambda f: pool.tick(), n=1,
                    ring_writes=tts_pool_launches(cfg)["ring_write4"],
                    rope=(pool.batch, m.num_heads, m.head_dim))


# name -> (CUDA source, the TPU kernel's pallas_call it replaces, the path
# whose frame launches it)
# ---------------------------------------------------------------------------
# the megakernel paths: sts_mega (MOSHI_TPU_MEGAKERNEL=all: K13 and K14c)
# and dep_mega (=dep where the frame kernel's preconditions fail: K14a)
# ---------------------------------------------------------------------------

def megakernel(knob: str):
    """MOSHI_TPU_MEGAKERNEL set to ``knob`` inside the block and restored
    after it, so that every other path runs as it did."""
    return env_set("MOSHI_TPU_MEGAKERNEL", knob)


def mega_launches(cfg):
    """Launches one B = 1 frame makes under MOSHI_TPU_MEGAKERNEL=all: K13
    and K14c once each, and K1 (one launch a call) for the text head and
    the depformer's stacked input projection."""
    return {"temporal_full_step": 1, "dep_frame_step": 1,
            "int8_matvec": 2}


def dep_mega_launches(cfg):
    """Launches one B = 1 frame makes under MOSHI_TPU_MEGAKERNEL=dep where
    the frame kernel's preconditions fail: the stacked temporal decode in
    the fused form (K1 for its qkv and linear_out, K5, K3, K4), K1 for the
    text head, and per depformer step K1 for its input projection and its
    logits and one K14a."""
    t = cfg.num_layers
    return {"int8_matvec": 2 * t + 1 + 2 * cfg.dep_q,
            "attn_ffn_fused": t, "decode_attention": t, "ring_write": 1,
            "dep_full_step": cfg.dep_q}


def _ordered(t):
    """bf16 values as integers in the order of their values (adjacent
    bf16 values one apart, +0 and -0 equal)."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def ring_rows_ok(got, ref, tol: float) -> bool:
    """Every bf16 element within one bf16 step of the plain version's, or
    within ``tol`` of the rows' largest magnitude."""
    near = (_ordered(got) - _ordered(ref)).abs() <= 1
    close = (got.float() - ref.float()).abs() <= tol * float(
        ref.float().abs().max())
    return bool((near | close).all())


@contextlib.contextmanager
def weights_unrounded():
    """The megakernels' plain versions with every dequantized weight
    element left in f32 (the kernels round it to bf16)."""
    from moshi_tpu_torch.nn import depformer, temporal
    with swapped(temporal, "_dequant_product", dequant_w_f32), \
            swapped(depformer, "_dequant_product", dequant_w_f32):
        yield


def _k13_p_f32(p, v, hd):
    from moshi_tpu_torch.nn import temporal
    pe = torch.repeat_interleave(p, hd, dim=1)
    return temporal._bf16_product(pe, v).sum(0)


def _exact_scores(k, q, hd):
    prod = k.float() * q.float()
    return prod.reshape(prod.shape[0], -1, hd).sum(-1)


def _exact_values(p, v, hd):
    pe = torch.repeat_interleave(p.to(torch.bfloat16).float(), hd, dim=1)
    return (pe * v.float()).sum(0)


def _rounded_values(p, v, hd):
    pe = torch.repeat_interleave(p.to(torch.bfloat16).float(), hd, dim=1)
    return _bf16_round(pe * v.float()).sum(0)


def mega_controls(which):
    """(name, context manager) of the megakernels' plain versions with one
    rounding changed: the weight elements left in f32 (K13 and K14), K13's
    p kept in f32, K13's bf16 products left exact (the form of K14 and
    the XLA path), K14's products p * v rounded to bf16 (K13's form)."""
    from moshi_tpu_torch.nn import depformer, temporal
    out = {"weights in f32": weights_unrounded,
           "K13 p in f32": lambda: swapped(temporal, "_weighted_values",
                                           _k13_p_f32),
           "K13 exact products": lambda: _both(
               swapped(temporal, "_head_scores", _exact_scores),
               swapped(temporal, "_weighted_values", _exact_values)),
           "K14 p*v rounded": lambda: swapped(depformer, "_dep_values",
                                              _rounded_values)}
    return [(n, out[n]) for n in which]


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _qt_bytes(qt, layers: int) -> int:
    return _qt_layer_bytes(qt, qt.q.shape[-2]) * layers


def _held(what, kernel, reading, controls, held):
    """Hold a reading to TOL[kernel] and each control in ``held`` above it
    (the others are logged)."""
    for name in held:
        check_limit(f"{what} (control: {name})", kernel, reading,
                    controls[name])


def _k13_weights(params, depth):
    lay = params["transformer"]["layers"]
    w = {"qkv": lay["self_attn"]["in_proj"]["weight"],
         "out": lay["self_attn"]["out_proj"]["weight"],
         "glu": lay["gating"]["linear_in"]["weight"],
         "lout": lay["gating"]["linear_out"]["weight"],
         "n1": lay["norm1"]["alpha"], "n2": lay["norm2"]["alpha"]}
    return {k: (v.with_eff_scales()._map(lambda a: a[:depth])
                if k not in ("n1", "n2") else v[:depth])
            for k, v in w.items()}


def k13_bound(w, depth: int, valid: int, dd: int, hidden: int, hd: int,
              ring_bytes: int):
    """K13's bound (ms, what bounds it, bytes) for ``depth`` layers
    reading ``valid`` ring slots of elements of ``ring_bytes`` bytes: every
    weight and norm once, the valid k and v rows, the new rows written,
    h in and out and the rope tables; the products' and the attention's
    operations in f32."""
    wbytes = sum(_qt_bytes(w[n], depth) for n in ("qkv", "out", "glu",
                                                 "lout"))
    nbytes = (wbytes + 2 * depth * dd * w["n1"].element_size()
              + 2 * depth * valid * dd * ring_bytes
              + 2 * depth * dd * ring_bytes + 2 * dd * 4
              + 2 * (hd // 2) * 4)
    elems = depth * dd * (3 * dd + dd + 2 * hidden + hidden)
    ops = 2.0 * elems + 4.0 * depth * (valid + 1) * dd
    return bound_ms(nbytes, ops, "f32") + (nbytes,)


def check_k13(params, cfg, gen):
    """K13 at the 7B's shapes on a fresh ring and on a full 3000-slot ring
    (all 32 layers), and at 2 layers on the full ring, where the
    attention's roundings are held."""
    from moshi_tpu_torch.nn import temporal as tm
    from moshi_tpu_torch.nn.rope import rope_angles
    tc = cfg.transformer
    dd, hidden, cap = tc.dim, tc.hidden_dim, tc.mha.cap
    chunk, cap_pad = tm.plan_stages(dd, hidden, cap)[4:6]
    rows = []
    nl = tc.num_layers
    every = ["weights in f32", "K13 p in f32", "K13 exact products"]
    for depth, label, off, calls, key, held in (
            (nl, f"{nl} layers, fresh ring", 0, 0, "temporal_full_step",
             every[:1]),
            (nl, f"{nl} layers, full ring", cap + 37, 1,
             "temporal_full_step_full", every),
            (2, "2 layers, full ring", cap + 37, 0, "temporal_full_step_2l",
             every)):
        w = _k13_weights(params, depth)
        kc = torch.zeros((depth, cap_pad, dd), dtype=torch.bfloat16,
                         device=DEV)
        vc = torch.zeros_like(kc)
        if off:
            kc[:, :cap].normal_(generator=gen)
            vc[:, :cap].normal_(generator=gen)
        pos = torch.tensor([off], dtype=torch.int32, device=DEV)
        cos_sin = rope_angles(pos, tc.mha.head_dim, tc.rope_max_period)
        hs = [torch.randn((1, dd), generator=gen, device=DEV)
              for _ in range(DRAWS)]
        kw = dict(cap=cap, context=tc.context, heads=tc.num_heads,
                  hidden=hidden, nlayers=depth)

        def run_kernel(i):
            return tm.temporal_full_step(hs[i % DRAWS], kc, vc, pos,
                                         cos_sin, w, **kw)

        def run_plain(i):
            return tm.temporal_full_step_plain(hs[i % DRAWS], kc, vc, pos,
                                               cos_sin, w, **kw)

        names = ["weights in f32", "K13 p in f32", "K13 exact products"]
        if not off:
            names = names[:1]      # a fresh ring has no slot to weigh
        max_err = max_rel = kv_rel = 0.0
        kv_ok = True
        ctls = {n: [] for n in names}
        for d in range(DRAWS):
            got, ref = run_kernel(d), run_plain(d)
            if not torch.isfinite(got[0]).all():
                fail(f"K13 ({label}): non-finite kernel output")
            max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
            max_rel = max(max_rel, rel_err(got[0], ref[0]))
            for i in (1, 2):
                kv_rel = max(kv_rel, rel_err(got[i], ref[i]))
                kv_ok &= ring_rows_ok(got[i], ref[i], TOL["mega_kv"])
            for name, ctx in mega_controls(names):
                with ctx():
                    ctls[name].append(rel_err(run_plain(d)[0], ref[0]))
        # the k/v rows (bf16) at 2 layers; at 32 the hidden states' flips
        # move some further (logged)
        if depth == 2 and not kv_ok:
            fail(f"K13 ({label}): k_new/v_new differ from the plain version "
                 f"beyond one bf16 step and {TOL['mega_kv']:g} of their "
                 f"largest value")
        ctl = {n: min(v) for n, v in ctls.items()}
        _held(f"K13 ({label})", key, max_rel, ctl, held)
        t_k = time_ms(run_kernel, REPS)
        t_p = time_ms(run_plain, 3)
        valid = min(cap - 1, tc.context - 1) if off else 0
        b_ms, b_by, nbytes = k13_bound(w, depth, valid, dd, hidden,
                                       tc.mha.head_dim, 2)
        rows.append({
            "kernel": "temporal_full_step", "shape": label, "layers": depth,
            "offset": off, "calls_per_frame": 0,
            "calls_per_mega_frame": calls, "max_abs_err": max_err,
            "max_rel_err": max_rel, "control_rel_err": min(
                ctl[n] for n in held), "controls": ctl,
            "kv_rel_err": kv_rel, "kv_within": kv_ok,
            "tol_rel": TOL[key], "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "blocks_per_call": k13_blocks(tc)})
        log(f"  temporal_full_step {label:22s} rel_err={max_rel:.2e} (tol "
            f"{TOL[key]:g}, controls "
            + ", ".join(f"{n} {v:.2e}" for n, v in ctl.items())
            + f"), k/v rel_err={kv_rel:.2e} (within one step or the limit: "
            f"{kv_ok})  {t_k:8.3f} ms  bound {b_ms:6.3f} ms  plain "
            f"{t_p:8.3f} ms  {rows[-1]['blocks_per_call']} blocks  "
            f"[{CARD}]")
    return rows


def _step_weights(step_w, norms, cb):
    w = {"qkv": step_w["attn"]["in_proj"]["weight"],
         "out": step_w["attn"]["out_proj"]["weight"],
         "glu": step_w["gating"]["linear_in"]["weight"],
         "lout": step_w["gating"]["linear_out"]["weight"]}
    w = {k: v.with_eff_scales()._map(lambda a: a[cb]) for k, v in w.items()}
    w["n1"], w["n2"] = norms
    return w


def check_k14a(params, cfg, gen):
    """K14a at the 7B depformer's shapes (its q4_0 linear_out) at each step
    cb of a frame, the rows before cb of the rings filled."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.nn import depformer as dp
    dcfg = cfg.depformer
    dd, cap, nl, dep_q = dcfg.dim, dcfg.mha.cap, dcfg.num_layers, cfg.dep_q
    dep = params["depformer"]
    step_w = lm._per_step_weights(cfg, dep)
    norms = (dep["layers"]["norm1"]["alpha"], dep["layers"]["norm2"]["alpha"])
    cases = []
    for cb in range(dep_q):
        w = _step_weights(step_w, norms, cb)
        kr = torch.zeros((nl, cap, dd), dtype=torch.bfloat16, device=DEV)
        vr = torch.zeros_like(kr)
        kr[:, :cb].normal_(generator=gen)
        vr[:, :cb].normal_(generator=gen)
        h = torch.randn((1, dd), generator=gen, device=DEV)
        cases.append((cb, w, kr, vr, h))
    kw = dict(cap=cap, heads=dcfg.num_heads, nlayers=nl)
    # the kernel's copy of each case's rings, made once: a repeated call at
    # one cb rewrites the same row with the same bits, so no copy sits in
    # the timed window
    rings = [(kr.clone(), vr.clone()) for _, _, kr, vr, _ in cases]

    def run_kernel(i):
        cb, w, _, _, h = cases[i % dep_q]
        return dp.dep_full_step(h, *rings[i % dep_q], cb, w, **kw)

    def run_plain(i):
        cb, w, kr, vr, h = cases[i % dep_q]
        return dp.dep_full_step_plain(h, kr.clone(), vr.clone(), cb, w, **kw)

    names = ["weights in f32", "K14 p*v rounded"]
    max_err = max_rel = 0.0
    ring_ok = True
    ctls = {n: 0.0 for n in names}
    for cb in range(dep_q):
        got, ref = run_kernel(cb), run_plain(cb)
        max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
        max_rel = max(max_rel, rel_err(got[0], ref[0]))
        ring_ok &= (ring_rows_ok(got[1], ref[1], TOL["mega_kv"])
                    and ring_rows_ok(got[2], ref[2], TOL["mega_kv"]))
        for name, ctx in mega_controls(names):
            with ctx():
                ctls[name] = max(ctls[name],
                                 rel_err(run_plain(cb)[0], ref[0]))
    if not ring_ok:
        fail("K14a: its ring rows differ from the plain version's by more "
             "than one bf16 step")
    _held("K14a (steps 0-7)", "dep_full_step", max_rel, ctls, names)
    t_k = time_ms(run_kernel, REPS)
    t_p = time_ms(run_plain, 3)
    w0 = cases[0][1]
    wbytes = sum(_qt_bytes(w0[n], nl) for n in ("qkv", "out", "glu", "lout"))
    hidden = dcfg.hidden_dim
    mean_valid = sum(min(cb + 1, cap) for cb in range(dep_q)) / dep_q
    nbytes = (wbytes + 2 * nl * dd * norms[0].element_size()
              + 2 * nl * (mean_valid - 1) * dd * 2 + 2 * nl * dd * 2
              + 2 * dd * 4)
    ops = (2.0 * nl * dd * (3 * dd + dd + 2 * hidden + hidden)
           + 4.0 * nl * mean_valid * dd)
    b_ms, b_by = bound_ms(nbytes, ops, "f32")
    log(f"  dep_full_step (K14a) steps 0-{dep_q - 1} rel_err={max_rel:.2e} "
        f"(tol {TOL['dep_full_step']:g}, controls "
        + ", ".join(f"{n} {v:.2e}" for n, v in ctls.items())
        + f")  {t_k:8.3f} ms  bound {b_ms:6.3f} ms  plain {t_p:8.3f} ms  "
        f"x{dep_q}/frame  [{CARD}]")
    return [{"kernel": "dep_full_step", "shape": f"7B depformer step, cb "
             f"0-{dep_q - 1}", "lout": w0["lout"].fmt, "calls_per_frame": 0,
             "calls_per_dep_mega_frame": dep_q, "max_abs_err": max_err,
             "max_rel_err": max_rel, "control_rel_err": min(ctls.values()),
             "controls": ctls,
             "tol_rel": TOL["dep_full_step"], "ms": t_k, "plain_ms": t_p,
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}]


def frame_margin(logits, noise, temp, top_k):
    """How far the frame kernel's choice is from changing, relative to the
    largest |logit / temp|: the top-1 minus top-2 logit at temp 0; at
    temp > 0 the least of the cut of the kept set (k-th minus (k+1)-th
    scaled value) and the top-1 minus top-2 of the kept values plus their
    noise (the noise follows the token id)."""
    if temp == 0.0:
        return float(_gap(logits))
    scaled = logits.float() / temp
    card = scaled.numel()
    k = min(top_k, card) if top_k > 0 else card
    desc = torch.sort(scaled, descending=True).values
    gaps = [float(desc[k - 1] - desc[k])] if k < card else []
    score = torch.where(scaled >= desc[k - 1], scaled + noise.float(),
                        torch.full_like(scaled, -1e30))
    top2 = torch.topk(score, 2).values
    gaps.append(float(top2[0] - top2[1]))
    return min(gaps) / float(scaled.abs().max())


def _frame_weights(params, cfg):
    from moshi_tpu_torch.models import lm
    dep = params["depformer"]
    sw = lm._per_step_weights(cfg, dep)
    w = {"qkv": sw["attn"]["in_proj"]["weight"],
         "out": sw["attn"]["out_proj"]["weight"],
         "glu": sw["gating"]["linear_in"]["weight"],
         "lout": sw["gating"]["linear_out"]["weight"],
         "linears": sw["linears"]["weight"]}
    w = {k: v.with_eff_scales() for k, v in w.items()}
    w["n1"] = dep["layers"]["norm1"]["alpha"]
    w["n2"] = dep["layers"]["norm2"]["alpha"]
    w["emb"] = lm._step_padded(sw["emb"]["weight"], cfg.dep_q)
    w["lr_w"] = lm._step_padded(sw["emb"]["low_rank"]["weight"], cfg.dep_q)
    return w


def check_k14c(params, cfg, gen):
    """K14c at the 7B's shapes: the whole depformer frame at temp 0 and at
    the pipeline's sampling defaults (temp 0.8, top-k 250) over DRAWS
    draws of its inputs and Gumbel noise; each step's logits (written out
    for the check) within the limit, and the tokens equal wherever the
    plain version's margin exceeds it."""
    from moshi_tpu_torch.nn import depformer as dp
    from moshi_tpu_torch.nn.sampling import gumbel
    dcfg = cfg.depformer
    dd, dep_q, card = dcfg.dim, cfg.dep_q, cfg.card
    w = _frame_weights(params, cfg)
    tol = TOL["dep_frame_step"]
    rows = []
    for temp, top_k, calls in ((0.0, 250, 0), (0.8, 250, 1)):
        draws = [(torch.randn((dep_q, 1, dd), generator=gen, device=DEV),
                  0.1 * torch.randn((1, dd), generator=gen, device=DEV),
                  gumbel((dep_q, 1, card), gen, DEV)) for _ in range(DRAWS)]
        kw = dict(cap=dcfg.mha.cap, heads=dcfg.num_heads,
                  nlayers=dcfg.num_layers, card=card, temp=temp, top_k=top_k)

        def run_kernel(i, logits_out=None):
            h_in, text, noise = draws[i % DRAWS]
            return dp.dep_frame_step(h_in, text, w, noise,
                                     logits_out=logits_out, **kw)

        def run_plain(i, logits_out=None):
            h_in, text, noise = draws[i % DRAWS]
            return dp.dep_frame_step_plain(h_in, text, w, noise,
                                           logits_out=logits_out, **kw)

        names = ["weights in f32", "K14 p*v rounded"]
        max_err = max_rel = 0.0
        agree = decided = 0
        ctls = {n: [] for n in names}
        for d in range(DRAWS):
            lk = torch.empty((dep_q, card), device=DEV)
            lp = torch.empty_like(lk)
            tk, tp = run_kernel(d, lk).cpu(), run_plain(d, lp).cpu()
            noise = draws[d][2]
            # once a token differs the later steps embed another one: the
            # logits are compared up to that step, where it must be
            # undecided (the plain version's margin within the limit)
            n = dep_q
            for s in range(dep_q):
                sure = frame_margin(lp[s], noise[s, 0], temp, top_k) > tol
                decided += int(sure)
                agree += int(sure and bool(tk[s] == tp[s]))
                if tk[s] != tp[s]:
                    n = s + 1
                    break
            max_err = max(max_err, float((lk[:n] - lp[:n]).abs().max()))
            max_rel = max(max_rel, rel_err(lk[:n], lp[:n]))
            for name, ctx in mega_controls(names):
                lc = torch.empty_like(lk)
                with ctx():
                    run_plain(d, lc)
                ctls[name].append(rel_err(lc[:n], lp[:n]))
        if agree != decided or decided < DRAWS:
            fail(f"K14c (temp {temp}): tokens agree on {agree} of the "
                 f"{decided} decided steps")
        ctl = {n: min(v) for n, v in ctls.items()}
        label = f"temp {temp:g}" + (f", top-k {top_k}" if temp else "")
        _held(f"K14c ({label}) logits", "dep_frame_step", max_rel, ctl,
              names)
        t_k = time_ms(run_kernel, REPS)
        t_p = time_ms(run_plain, 3)
        nl, hidden, lr = dcfg.num_layers, dcfg.hidden_dim, w["emb"].shape[-1]
        wbytes = sum(_qt_bytes(w[n], dep_q * nl)
                     for n in ("qkv", "out", "glu", "lout"))
        wbytes += _qt_bytes(w["linears"], dep_q)
        nbytes = (wbytes + 2 * nl * dd * w["n1"].element_size()
                  + (dep_q - 1) * (lr + dd * lr) * w["emb"].element_size()
                  + dep_q * dd * 4 + dd * 4 + dep_q * 4
                  + (dep_q * card * 4 if temp else 0))
        ops = (2.0 * dep_q * nl * dd * (3 * dd + dd + 3 * hidden)
               + 2.0 * dep_q * card * dd + 2.0 * (dep_q - 1) * dd * lr)
        b_ms, b_by = bound_ms(nbytes, ops, "f32")
        rows.append({
            "kernel": "dep_frame_step", "shape": f"7B depformer frame, "
            f"{label}", "temp": temp, "top_k": top_k, "calls_per_frame": 0,
            "calls_per_mega_frame": calls, "max_abs_err": max_err,
            "max_rel_err": max_rel, "control_rel_err": min(ctl.values()),
            "controls": ctl, "tol_rel": tol, "tokens_agree": agree, "tokens_decided": decided,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes})
        log(f"  dep_frame_step (K14c) {label:16s} logits rel_err="
            f"{max_rel:.2e} (tol {tol:g}, controls "
            + ", ".join(f"{n} {v:.2e}" for n, v in ctl.items())
            + f"), tokens {agree}/{decided} decided  {t_k:8.3f} ms  bound "
            f"{b_ms:6.3f} ms  plain {t_p:8.3f} ms  [{CARD}]")
    return rows


def check_megakernels(params, cfg, gen):
    """Phase 3 (sts_mega, dep_mega): K13, K14a and K14c against their
    plain versions at the 7B's shapes."""
    return (check_k13(params, cfg, gen) + check_k14a(params, cfg, gen)
            + check_k14c(params, cfg, gen))


def flat_long_session(cfg, state, gen):
    """``state`` (the flat layout) past its first ring's worth of frames:
    offset cap + 37, every ring slot and delay-cache slot random."""
    fill_rings(state, gen)
    state["cache"] = torch.randint(0, cfg.card, state["cache"].shape,
                                   generator=gen, device=state["cache"].device)
    state["offset"].fill_(cfg.transformer.mha.cap + 37)
    return state


def _mega_session(cfg, params, others, device, state, lead=None,
                  keep=None):
    """Frames at temp 0 from a copy of ``state`` on ``device``, each with
    transformer_out, the text logits, every depformer step's logits (the
    input of ``sample_token``, of the frame kernel's plain sampler, or
    written out by the frame kernel) and the tokens each sampler chose.
    With ``lead`` (another run's frames) every sampler then returns that
    run's token instead, so that this run follows it token for token and
    every frame's logits come from the same inputs as the lead's.  The
    format is ``_session``'s ("text" the run's own choice);
    ``keep["state"]`` receives the final state."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.nn import depformer
    state = _state_copy(state, device)
    sample, frame, scaled = (lm.sample_token, lm.dep_frame_step,
                             depformer.sample_scaled)
    rec = {}

    def follow(own, key):
        rec[key].append(own.reshape(-1)[:1].cpu())
        if lead is None:
            return own
        return lead[len(res)][key][len(rec[key]) - 1].to(own.device) \
            .reshape(own.shape).to(own.dtype)

    def rec_sample(logits, *a, **kw):
        own = sample(logits, *a, **kw)
        if logits.shape[-1] == cfg.card:
            rec["dep"].append(logits.float().cpu())
            return follow(own, "dep_own")
        return follow(own, "text_own")

    def rec_scaled(logits, noise, *a, **kw):
        own = scaled(logits, noise, *a, **kw)
        rec["dep"].append(logits.float().cpu()[None])
        return follow(own, "dep_own")

    def rec_frame(h_in_all, *a, **kw):
        if not h_in_all.is_cuda:      # the plain version samples in Python
            return frame(h_in_all, *a, **kw)
        if lead is not None:
            raise ValueError("the frame kernel cannot follow another run")
        lo = torch.empty((h_in_all.shape[0], cfg.card), device=device)
        tokens = frame(h_in_all, *a, logits_out=lo, **kw)
        rec["dep"].extend(lo.cpu()[:, None])
        rec["dep_own"].extend(tokens.cpu()[:, None])
        return tokens

    res = []
    for other in others:
        for key in ("dep", "dep_own", "text_own"):
            rec[key] = []
        with swapped(lm, "sample_token", rec_sample), \
                swapped(lm, "dep_frame_step", rec_frame), \
                swapped(depformer, "sample_scaled", rec_scaled):
            out, state, h, logits = _frame(cfg, params, state,
                                           other.to(device), lm)
        res.append({"h": h.cpu(), "logits": logits.cpu(),
                    "dep_logits": torch.stack(rec["dep"], 1), "vad": None,
                    "text": rec["text_own"][0],
                    "text_own": list(rec["text_own"]),
                    "dep_own": list(rec["dep_own"]),
                    "tokens": torch.cat([out["text"][:, None],
                                         out["audio"]], dim=1).cpu()})
    if keep is not None:
        keep["state"] = state
    return res


@reused_plain_weights()
def compare_mega_two_layers():
    """Phase 4 (sts_mega): 2 layers of the 7B geometry under
    MOSHI_TPU_MEGAKERNEL=all, card against CPU, for SEEDS_MEGA weight
    seeds, fresh and on a full ring; the controls run on the first seed's
    full ring.  The CPU follows the card's tokens (``_mega_session``), so
    every frame's logits come from the same inputs; each token the CPU
    chose must equal the card's wherever the CPU's margin exceeds the
    limit (the text head's and the depformer input's K1 round their
    activations to int8, so a last-bit difference can move a logit by
    about one int8 step)."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = lm.LMConfig(delays=_7B_DELAYS, num_layers=2)
    tol, tol_dep = TOL["mega_2l"], TOL["mega_2l_dep"]
    readings, controls = [], {}
    with megakernel("all"):
        for s in range(SEEDS_MEGA):
            params = synth_lm_params(cfg, "q4_k", device=DEV,
                                     seed=SEED + 1 + s)
            params_cpu = tree_to(params, "cpu")
            gen = torch.Generator().manual_seed(SEED + 300 + s)
            others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                                    generator=gen) for _ in range(FRAMES_2L)]
            for label in ("fresh", "full ring"):
                state = lm.init_gen_state(cfg, 1, device="cpu",
                                          params=params_cpu)
                if state["transformer"]["k"].dim() != 3:
                    fail("sts_mega: init_gen_state did not take the flat "
                         "layout")
                if label == "full ring":
                    state = flat_long_session(cfg, state, gen)
                card = _mega_session(cfg, params, others, DEV, state)
                cpu = _mega_session(cfg, params_cpu, others, "cpu", state,
                                    lead=card)
                r = dict(_compare(card, cpu, tol, tol_dep,
                                  decided_only=True),
                         seed=SEED + 1 + s, state=label)
                readings.append(r)
                log(f"  megakernels, seed {SEED + 1 + s}, {label}: "
                    f"{_show(r)}")
                if s == 0 and label == "full ring":
                    for name, ctx in mega_controls(
                            ["weights in f32", "K13 p in f32",
                             "K14 p*v rounded"]):
                        with ctx():
                            ctl = _mega_session(cfg, params_cpu, others,
                                                "cpu", state, lead=card)
                        controls[name] = _compare(ctl, cpu, tol, tol_dep,
                                                  decided_only=True)
                        log(f"  megakernels, control ({name}) against the "
                            f"CPU: {_show(controls[name])}")
    for r in readings:
        if not r["passes"]:
            fail(f"2-layer megakernel frame, seed {r['seed']}, {r['state']}:"
                 f" card and CPU differ beyond {tol:g} (depformer "
                 f"{tol_dep:g}) or in a decided token: {_show(r)}")
    # K14's own rounding moves these frames less than K1's int8 roundings
    # do; it is held against K14's plain version in phase 3 (logged here)
    for name in ("weights in f32", "K13 p in f32"):
        if controls[name]["passes"]:
            fail(f"2-layer megakernel frame: the control ({name}) passes the "
                 f"check: it cannot tell that rounding apart")
    return {"frames": FRAMES_2L, "readings": readings, "controls": controls,
            "tol_rel": tol, "tol_dep_rel": tol_dep}


@reused_plain_weights()
def compare_dep_mega_two_layers():
    """Phase 4 (dep_mega): the path that launches K14a.  The 7B meets the
    frame kernel's preconditions, so this path takes 2 layers of the 7B
    geometry with a card of MEGA_K14A_CARD (not a multiple of 128) under
    MOSHI_TPU_MEGAKERNEL=dep: the stacked temporal decode, then per
    depformer step one K14a launch, its logits through K1.  The launches
    are counted over FRAMES_2L frames of lm_gen_step on the card, then
    the frames are compared card against CPU."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = lm.LMConfig(delays=_7B_DELAYS, num_layers=2, card=MEGA_K14A_CARD)
    tol, tol_dep = TOL["frame_2l"], TOL["dep_mega_2l_dep"]
    with megakernel("dep"):
        params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 1)
        dep = params["depformer"]
        sw = lm._per_step_weights(cfg, dep)
        if not (lm._can_use_dep_megakernel(cfg, dep, 1)
                and not lm._can_use_dep_frame_kernel(cfg, dep, sw, 1)):
            fail("dep_mega: the configuration does not select K14a")
        params_cpu = tree_to(params, "cpu")
        gen = torch.Generator().manual_seed(SEED + 310)
        others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                                generator=gen) for _ in range(FRAMES_2L)]
        state = lm.init_gen_state(cfg, 1, device=DEV)
        sync()
        build.COUNTS.clear()                  # the path starts here
        for other in others:
            out, state = lm.lm_gen_step(cfg, params, state,
                                        other_audio=other.to(DEV), temp=0.0,
                                        temp_text=0.0)
        out["audio"].cpu()
        counts = dict(build.COUNTS)           # the path ends here
        per_frame = dep_mega_launches(cfg)
        if counts != {k: v * FRAMES_2L for k, v in per_frame.items()}:
            fail(f"dep_mega: launch counts over {FRAMES_2L} frames: "
                 f"{counts}, expected {per_frame} per frame")
        state = lm.init_gen_state(cfg, 1, device="cpu")
        card = _mega_session(cfg, params, others, DEV, state)
        cpu = _mega_session(cfg, params_cpu, others, "cpu", state, lead=card)
        r = _compare(card, cpu, tol, tol_dep, decided_only=True)
        log(f"  K14a path (card {cfg.card}), seed {SEED + 1}: {_show(r)}; "
            f"launches per frame {per_frame}")
        controls = {}
        for name, ctx in mega_controls(["weights in f32",
                                        "K14 p*v rounded"]):
            with ctx():
                ctl = _mega_session(cfg, params_cpu, others, "cpu", state,
                                    lead=card)
            controls[name] = _compare(ctl, cpu, tol, tol_dep,
                                      decided_only=True)
            log(f"  K14a path, control ({name}) against the CPU: "
                f"{_show(controls[name])}")
    if not r["passes"]:
        fail(f"dep_mega 2-layer frame: card and CPU differ beyond {tol:g} "
             f"(depformer {tol_dep:g}) or in a decided token: {_show(r)}")
    # here the stacked int8 temporal stack and K1 on K14a's output set the
    # frames' spread, above what K14a's roundings move them: those are
    # held against its plain version in phase 3 (logged here)
    return dict(r, frames=FRAMES_2L, card=cfg.card, controls=controls,
                launches_per_frame=per_frame, tol_rel=tol,
                tol_dep_rel=tol_dep)


# ---------------------------------------------------------------------------
# the knob paths: sts_mxu (MOSHI_TPU_ATTN_MXU=1 with MOSHI_TPU_KSEG=1: K10
# and K12's k-segment form) and lm_split (MOSHI_TPU_ATTN_MXU=1 with
# MOSHI_TPU_SPLIT_SPREAD=1: K10 and K12's split-spread form)
# ---------------------------------------------------------------------------

_KNOBS = {"sts_mxu": {"MOSHI_TPU_ATTN_MXU": "1", "MOSHI_TPU_KSEG": "1",
                      "MOSHI_TPU_SPLIT_SPREAD": "0"},
          "lm_split": {"MOSHI_TPU_ATTN_MXU": "1", "MOSHI_TPU_KSEG": "0",
                       "MOSHI_TPU_SPLIT_SPREAD": "1"}}
_K12 = {"sts_mxu": "int8_kseg", "lm_split": "int8_split"}


@contextlib.contextmanager
def knobs(path: str):
    """The knobs of ``path`` set inside the block and restored after it,
    so that every other path runs as it did."""
    with contextlib.ExitStack() as stack:
        for name, value in _KNOBS[path].items():
            stack.enter_context(env_set(name, value))
        yield


def mxu_launches(cfg, path: str = "sts_mxu"):
    """Launches one B = 1 frame makes under ``path``: the default fused
    frame with K10 in place of K3 in every temporal layer and depformer
    step-layer, and K12 (one launch a call) in place of K1 for each
    temporal linear_out."""
    counts = per_frame_launches(cfg)
    t = cfg.num_layers
    counts["decode_attention_mxu"] = counts.pop("decode_attention")
    counts["int8_matvec"] -= t
    counts[_K12[path]] = t
    return counts


def rms_rel(got, ref) -> float:
    """Per session (the leading axis), the root mean square of the error
    relative to the session's largest value; the largest of these."""
    err = (got.double() - ref.double()).flatten(1)
    scale = ref.double().abs().flatten(1).amax(dim=1).clamp_min(1e-30)
    return float((err.pow(2).mean(dim=1).sqrt() / scale).max())


def _k10_controls(da, hd: int, cap: int, valid: int):
    """(name, context manager, chunk) of K10's controls that can move its
    output here: its plain version with p . v left in f32, with the scale
    applied after the sum (not at hd 64, where the scale 1/8 commutes with
    every rounding), and with K3's chunk (where it differs, and a session's
    ``valid`` ring slots reach past the smaller chunk); K3's function is
    the fourth (``check_k10``)."""
    chunk, k3_chunk = da.chunk_for_mxu(cap), da.chunk_for(cap)
    out = [("p.v in f32", lambda: swapped(da, "_pv_round", lambda t: t),
            chunk)]
    if hd != 64:
        out.append(("scale after the sum", lambda: swapped(
            da, "_scores_query", lambda qf, scale: (qf, scale)), chunk))
    if k3_chunk != chunk and valid > min(chunk, k3_chunk):
        out.append(("K3's chunk", contextlib.nullcontext, k3_chunk))
    return out


def check_k10(cfg, gen, batch: int):
    """Phase 3 (sts_mxu): K10 against its plain version.  At B = 1 the
    7B temporal ring in three states (a fresh session, a partly filled
    ring, a wrapped one whose window is full) and the depformer ring at
    each step; at B = ``batch`` both with every session at another age.
    A flipped bf16 rounding of a chunk's p . v moves one element by one
    bf16 step of that chunk's contribution, as far as a control moves
    it, so K10 is held by the root mean square of its error per session
    (``rms_rel``, TOL decode_attention_mxu) with every element within
    TOL decode_attention_mxu_max of the largest; the controls (K3's
    function, and ``_k10_controls``) move every element and must read
    above the first.
    Sessions at age 0 see no ring slot and return the seed alone in every
    form: they are left out of the controls.  The rings hold two layers."""
    from moshi_tpu_torch.nn import decode_attention as da
    bf = torch.bfloat16
    tcfg, dcfg = cfg.transformer, cfg.depformer
    cap = tcfg.mha.cap
    if batch == 1:
        cases = [("temporal, full ring", tcfg, [[cap + 7]], tcfg.num_layers),
                 ("temporal, partly filled", tcfg, [[cap // 3]], 0),
                 ("temporal, path state (16 positions)", tcfg, [[16]], 0),
                 ("depformer, steps 0-7", dcfg,
                  [[cb] for cb in range(cfg.dep_q)], dcfg.num_layers)]
    else:
        cases = [(f"B={batch} temporal, {batch} ages", tcfg,
                  [pool_offsets(cap, batch)], 0),
                 (f"B={batch} depformer, ages 0-{batch - 1}", dcfg,
                  [[i % cfg.dep_q for i in range(batch)]], 0)]
    tol, tol_max = TOL["decode_attention_mxu"], TOL["decode_attention_mxu_max"]
    rows = []
    for label, tc, offset_sets, calls in cases:
        m = tc.mha
        shape = (2, batch, m.cap, m.num_heads, m.head_dim)
        k_ring = torch.randn(shape, generator=gen, device=DEV).to(bf)
        v_ring = torch.randn(shape, generator=gen, device=DEV).to(bf)
        cur = [[torch.randn((batch, m.num_heads, m.head_dim), generator=gen,
                            device=DEV).to(bf) for _ in range(3)]
               for _ in range(DRAWS)]
        t_k = t_p = t_l = b_ms = nbytes = 0.0
        max_err = max_rel = max_rms = 0.0
        controls = {}
        chunk = da.chunk_for_mxu(m.cap)
        for offs in offset_sets:
            offset = torch.tensor(offs, dtype=torch.int32, device=DEV)
            live = offset > 0

            def run_kernel(i, d=0):
                c = cur[d]
                return da.decode_attention_stacked(
                    c[0], k_ring, v_ring, c[1], c[2], offset, i % 2,
                    cap=m.cap, context=tc.context)

            def run_plain(i, d=0, ch=chunk):
                c = cur[d]
                return da.decode_attention_mxu_plain(
                    c[0], k_ring[i % 2], v_ring[i % 2], c[1], c[2], offset,
                    cap=m.cap, context=tc.context, chunk=ch)

            def run_k3(i, d=0):
                c = cur[d]
                return da.decode_attention_plain(
                    c[0], k_ring[i % 2], v_ring[i % 2], c[1], c[2], offset,
                    cap=m.cap, context=tc.context,
                    chunk=da.chunk_for(m.cap))

            def run_lib(i):
                kk = k_ring[i % 2].transpose(1, 2)         # [B, H, cap, hd]
                vv = v_ring[i % 2].transpose(1, 2)
                return torch.nn.functional.scaled_dot_product_attention(
                    cur[0][0][:, :, None], kk, vv)

            with knobs("sts_mxu"):
                for lyr in (0, 1):
                    for d in range(DRAWS):
                        got = run_kernel(lyr, d)
                        ref = run_plain(lyr, d)
                        if not torch.isfinite(got).all():
                            fail(f"K10 ({label}): non-finite output")
                        max_err = max(max_err,
                                      float((got - ref).abs().max()))
                        max_rel = max(max_rel, rel_err(got, ref))
                        max_rms = max(max_rms, rms_rel(got, ref))
                        if m.head_dim == 64:
                            with swapped(da, "_scores_query",
                                         lambda qf, scale: (qf, scale)):
                                if not torch.equal(run_plain(lyr, d), ref):
                                    fail(f"K10 ({label}): at hd 64 the "
                                         f"scale after the sum changed the "
                                         f"plain version")
                        if not live.any():
                            continue
                        ctl = {"K3": run_k3(lyr, d)}
                        for name, ctx, ch in _k10_controls(
                                da, m.head_dim, m.cap,
                                max(min(o, tc.context - 1) for o in offs)):
                            with ctx():
                                ctl[name] = run_plain(lyr, d, ch)
                        for name, y in ctl.items():
                            reading = rms_rel(y[live], ref[live])
                            box = controls.setdefault(name, [0.0] * DRAWS)
                            box[d] = max(box[d], reading)
                t_k += time_ms(run_kernel, REPS)
            t_p += time_ms(run_plain, max(REPS // 4, 3))
            t_l += time_ms(run_lib, REPS)
            row = m.num_heads * m.head_dim
            valid = sum(max(0, min(off, tc.context - 1)) for off in offs)
            nb = valid * row * 2 * 2 + batch * (3 * row * 2 + row * 4)
            nbytes += nb
            b_ms += bound_ms(nb, 4.0 * (valid + batch) * row, "f32")[0]
        # the draw on which each control shows least
        ctl = {name: min(v) for name, v in controls.items()}
        what = f"K10 ({label})"
        if not max_rms <= tol:
            fail(f"{what}: relative RMS error {max_rms:.3e} > {tol:g}")
        if not max_rel <= tol_max:
            fail(f"{what}: relative error {max_rel:.3e} > {tol_max:g}")
        for name, reading in ctl.items():
            if not reading > tol:
                fail(f"{what}: the control ({name}) reads {reading:.3e}, "
                     f"within the limit {tol:g}: the check cannot tell that "
                     f"rounding apart")
        n = len(offset_sets)
        blocks = attention_blocks(batch, m, chunk)
        rows.append({
            "kernel": "decode_attention_mxu", "shape": label, "B": batch,
            "H": m.num_heads, "hd": m.head_dim, "cap": m.cap,
            "chunk": chunk, "blocks_per_call": blocks,
            "offsets": offset_sets, "calls_per_frame": 0,
            "calls_per_mxu_frame": calls * n,
            "calls_per_split_frame": calls * n, "max_abs_err": max_err,
            "max_rel_err": max_rel, "rms_rel_err": max_rms,
            "controls": ctl, "control_rel_err": min(ctl.values()),
            "tol_rel": tol, "tol_max_rel": tol_max,
            "ms": t_k / n, "plain_ms": t_p / n, "library_ms": t_l / n,
            "bound_ms": b_ms / n, "bound_by": "bytes", "bytes": nbytes / n})
        log(f"  decode_attention_mxu {label:36s} rms {max_rms:.2e} (tol "
            f"{tol:g}), max {max_rel:.2e} (tol {tol_max:g}), controls "
            + ", ".join(f"{k} {v:.2e}" for k, v in ctl.items())
            + f"  {t_k / n * 1e3:8.1f} us  bound {b_ms / n * 1e3:7.2f} us  "
            f"plain {t_p / n * 1e3:9.1f} us  sdpa {t_l / n * 1e3:7.1f} us  "
            f"{blocks} blocks  [{CARD}]")
    return rows


def check_attention_workspace(cfg, gen, batch: int):
    """Phase 3 (workspace): K3 (bf16 and fp8 rings) and K10 share one
    workspace per device (``decode_attention.workspace``), which every
    call must leave as it found it: its sync region zero.  Each case is
    called twice in a row on the same inputs, the shapes changing between
    the pairs (the 7B temporal ring at B = 1 and B = ``batch``, the
    depformer's ring of one chunk, fresh and full rings); both calls must
    give the same bits, the sync region must read zero after them, and
    the workspace must be the one the earlier phases left (no call of
    this phase needs more)."""
    from moshi_tpu_torch.nn import decode_attention as da
    bf = torch.bfloat16
    tcfg, dcfg = cfg.transformer, cfg.depformer
    cap = tcfg.mha.cap
    ages = pool_offsets(cap, batch)
    before = da._WORKSPACE.get(torch.device(DEV, 0) if DEV == "cuda"
                               else torch.device(DEV))
    out = []
    for kernel, tc, offs in (("K3", tcfg, [cap + 7]), ("K10", tcfg, ages),
                             ("K3", dcfg, [5]), ("K3 fp8", tcfg, ages),
                             ("K3", tcfg, [16]), ("K10", tcfg, [cap + 7]),
                             ("K3", tcfg, ages), ("K3 fp8", tcfg, [cap + 7]),
                             ("K10", dcfg, [7])):
        m, b = tc.mha, len(offs)
        shape = (2, b, m.cap, m.num_heads, m.head_dim)
        if kernel == "K3 fp8":
            k_ring, v_ring = fp8_ring(shape, gen), fp8_ring(shape, gen)
        else:
            k_ring, v_ring = (torch.randn(shape, generator=gen, device=DEV)
                              .to(bf) for _ in range(2))
        cur = [torch.randn((b, m.num_heads, m.head_dim), generator=gen,
                           device=DEV).to(bf) for _ in range(3)]
        offset = torch.tensor(offs, dtype=torch.int32, device=DEV)
        mxu = kernel == "K10"
        with knobs("sts_mxu") if mxu else contextlib.nullcontext():
            first, second = (da.decode_attention_stacked(
                cur[0], k_ring, v_ring, cur[1], cur[2], offset, 1,
                cap=m.cap, context=tc.context) for _ in range(2))
        sync()
        label = (f"{kernel} {'temporal' if tc is tcfg else 'depformer'} "
                 f"B={b} offsets {offs if b == 1 else 'pool'}")
        if not torch.equal(first.view(torch.int32), second.view(torch.int32)):
            fail(f"{label}: a second call on the same workspace differs from "
                 f"the first")
        ws = da._WORKSPACE.get(first.device)
        left = 0 if ws is None else int(ws[0].count_nonzero())
        if left:
            fail(f"{label}: {left} bytes of the workspace's sync region are "
                 f"not zero after the calls")
        chunk = da.chunk_for_mxu(m.cap) if mxu else da.chunk_for(m.cap)
        plan = da.launch_plan(b, m.num_heads, m.head_dim, m.cap, chunk)
        out.append({"case": label, "blocks_per_call": plan.blocks,
                    "chunks": plan.chunks, "sync_bytes": plan.sync_bytes,
                    "parts_bytes": plan.parts_bytes})
        log(f"  {label:42s} two calls bit-identical, the sync region zero "
            f"after; {plan.blocks} blocks, {plan.chunks} chunks  [{CARD}]")
        del k_ring, v_ring
    after = da._WORKSPACE.get(first.device)
    if before is not None and (after[0] is not before[0]
                               or after[1] is not before[1]):
        fail("the workspace was allocated anew during the phase: a call "
             "needed more than the earlier phases' calls")
    if after is not None:
        log(f"  workspace: sync region {after[0].numel()} bytes, parts "
            f"{after[1].numel()} bytes, reused by every call of the phase")
    return out


def check_k9_workspace(scfg, tcfg, gen, batch: int):
    """Phase 3 (workspace): K9 (bf16 and fp8 rings) takes the device's
    workspace too (``decode_attention.workspace``), which every call must
    leave as it found it.  Each case is called twice in a row on the same
    inputs, the shapes changing between the pairs (the stt-1b ring fresh,
    partly filled and wrapped; the TTS ring at B = 1 and at B =
    ``batch`` at ``pool_offsets``); both calls must give the same bits,
    the sync region must read zero after them, and the workspace must be
    the one the earlier phases left."""
    from moshi_tpu_torch.nn import decode_attention as da
    bf = torch.bfloat16
    scap, tcap = scfg.transformer.mha.cap, tcfg.transformer.mha.cap
    before = da._WORKSPACE.get(torch.device(DEV, 0) if DEV == "cuda"
                               else torch.device(DEV))
    out, first = [], None
    for kernel, cfg, offs in (
            ("K9", scfg, [scap + 37]), ("K9", tcfg, pool_offsets(tcap, batch)),
            ("K9 fp8", scfg, [scap // 8]), ("K9", scfg, [(2 * scap) // 3]),
            ("K9", tcfg, [tcap + 37]), ("K9 fp8", tcfg,
                                        pool_offsets(tcap, batch)),
            ("K9 fp8", scfg, [scap + 37]), ("K9", scfg, [scap // 8])):
        m, b = cfg.transformer.mha, len(offs)
        shape = (b, m.cap, m.num_heads, m.head_dim)
        if kernel == "K9 fp8":
            kc, vc = fp8_ring(shape, gen), fp8_ring(shape, gen)
        else:
            kc, vc = (torch.randn(shape, generator=gen, device=DEV).to(bf)
                      for _ in range(2))
        q = torch.randn((b, m.num_heads, m.head_dim), generator=gen,
                        device=DEV).to(bf)
        offset = torch.tensor(offs, dtype=torch.int32, device=DEV)
        first, second = (da.decode_attention(q, kc, vc, offset, cap=m.cap,
                                             context=cfg.context)
                         for _ in range(2))
        sync()
        label = (f"{kernel} {'stt' if cfg is scfg else 'tts'} B={b} offsets "
                 f"{offs if b == 1 else 'pool'}")
        if not torch.equal(first.view(torch.int32), second.view(torch.int32)):
            fail(f"{label}: a second call on the same workspace differs from "
                 f"the first")
        ws = da._WORKSPACE.get(first.device)
        left = 0 if ws is None else int(ws[0].count_nonzero())
        if left:
            fail(f"{label}: {left} bytes of the workspace's sync region are "
                 f"not zero after the calls")
        plan = da.launch_plan(b, m.num_heads, m.head_dim, m.cap,
                              da.chunk4_for(m.cap), ragged=True)
        out.append({"case": label, "blocks_per_call": plan.blocks,
                    "chunks": plan.chunks, "sync_bytes": plan.sync_bytes,
                    "parts_bytes": plan.parts_bytes})
        log(f"  {label:42s} two calls bit-identical, the sync region zero "
            f"after; {plan.blocks} blocks, {plan.chunks} chunks  [{CARD}]")
        del kc, vc
    after = da._WORKSPACE.get(first.device)
    if before is not None and (after[0] is not before[0]
                               or after[1] is not before[1]):
        fail("the workspace was allocated anew during K9's calls: a call "
             "needed more than the earlier phases' calls")
    return out


def k12_tie_input(k: int, seed: int):
    """A bf16 row [1, k] on which the block scale's two roundings differ:
    each 32-block's largest value is one whose quotient by 127 and
    product with f32(1/127) differ in the last bit, and 8 of its elements
    are +-half of it, so x / dx lands on or just off a .5 tie."""
    g = torch.Generator().manual_seed(seed)
    nb = k // 32
    cand = 1 + torch.arange(128, dtype=torch.float32) / 128
    cand = cand[cand / 127 != cand * (1 / 127)]
    amax = cand[torch.randint(0, len(cand), (nb,), generator=g)]
    x = torch.rand((nb, 32), generator=g) * 0.8 - 0.4
    x[:, 0] = amax
    sign = torch.randint(0, 2, (nb, 8), generator=g).float() * 2 - 1
    x[:, 1:9] = amax[:, None] / 2 * sign
    return x.reshape(1, k).to(torch.bfloat16).to(DEV)


def quantize_by_quotient(x, alpha=None):
    """K1's activation quantization with the block scale formed as the
    quotient amax / 127, where XLA forms amax * f32(1/127)."""
    if alpha is not None:
        raise ValueError("the quotient control takes no norm")
    blocks = x.float().reshape(tuple(x.shape[:-1]) + (-1, 32))
    amax = blocks.abs().amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which is the rounding this control must not take
    dx = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                     torch.ones_like(amax))
    xq = torch.round(blocks / dx[..., None])
    return xq, dx, xq.sum(dim=-1) * dx


def check_k12(params, cfg, gen):
    """Phase 3 (sts_mxu, lm_split): K12 in both forms at the 7B temporal
    linear_out (q4_k, O 4096, K 11264, bf16 activation, no norm) at layers
    0 and L-1 over DRAWS draws and an input with ties (``k12_tie_input``),
    against each form's plain version (the f32 order of the block terms'
    sums alone); control: the block scale as a quotient
    (``quantize_by_quotient``) on the input with ties."""
    from moshi_tpu_torch.quant import matmul_int8 as mi
    from moshi_tpu_torch.quant.formats import dequantize
    qt = params["transformer"]["layers"]["gating"]["linear_out"]["weight"]
    layers = cfg.num_layers
    k, o = qt.shape[-1], qt.q.shape[-2]
    if not mi.kseg_ok(qt, 1, False):
        fail(f"K12: the temporal linear_out ({qt.fmt}, K={k}) does not "
             f"qualify")
    qte = qt.with_eff_scales()
    xs = [torch.randn((1, k), generator=gen, device=DEV).to(torch.bfloat16)
          for _ in range(DRAWS)] + [k12_tie_input(k, SEED + 22)]
    rows = []
    lib_layers = min(layers, 2)
    wd = dequantize(_first_layers(qt, lib_layers))       # [n, O, K] bf16
    for path, plain in (("sts_mxu", mi.int8_matvec_kseg_plain),
                        ("lm_split", mi.int8_matvec_split_plain)):
        name = _K12[path]

        def run_kernel(i, layer=None, x=None):
            lyr = (i % layers) if layer is None else layer
            return mi.qmatmul_i8(xs[i % DRAWS] if x is None else x, qt,
                                 layer=lyr)

        def run_plain(i, layer=None, x=None):
            lyr = (i % layers) if layer is None else layer
            return plain(xs[i % DRAWS] if x is None else x, qte, lyr)

        def run_lib(i):
            return torch.matmul(xs[i % DRAWS], wd[i % lib_layers].T)

        max_err = max_rel = 0.0
        with knobs(path):
            for lyr in sorted({0, layers - 1}):
                for x in xs:
                    got = run_kernel(0, lyr, x).reshape(-1)
                    ref = run_plain(0, lyr, x).reshape(-1)
                    if not torch.isfinite(got).all():
                        fail(f"{name}: non-finite kernel output")
                    max_err = max(max_err, float((got - ref).abs().max()))
                    max_rel = max(max_rel, rel_err(got, ref))
            tie_ref = run_plain(0, layers - 1, xs[-1])
            with swapped(mi, "quantize_activation", quantize_by_quotient):
                ctl = rel_err(run_plain(0, layers - 1, xs[-1]), tie_ref)
            check_limit(f"{name} (temporal linear_out)", name, max_rel, ctl)
            t_kernel = time_ms(run_kernel, REPS)
        t_plain = time_ms(run_plain, max(REPS // 4, 3))
        t_lib = time_ms(run_lib, REPS)
        nbytes = _qt_layer_bytes(qt, o) + k * 2 + o * 4
        b_ms, b_by = bound_ms(nbytes, 2.0 * o * k, "int8")
        key = "calls_per_mxu_frame" if path == "sts_mxu" else \
            "calls_per_split_frame"
        rows.append({
            "kernel": name, "shape": "temporal linear_out", "fmt": qt.fmt,
            "O": o, "K": k, "segments": mi.kseg_nsegs(k),
            "calls_per_frame": 0, key: layers, "max_abs_err": max_err,
            "max_rel_err": max_rel, "control_rel_err": ctl,
            "tol_rel": TOL[name], "ms": t_kernel, "plain_ms": t_plain,
            "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes})
        log(f"  {name:15s} temporal linear_out q4_k O={o} K={k} rel_err="
            f"{max_rel:.2e} (tol {TOL[name]:g}, control {ctl:.2e})  "
            f"{t_kernel * 1e3:8.1f} us  bound {b_ms * 1e3:7.1f} us  plain "
            f"{t_plain * 1e3:9.1f} us  lib {t_lib * 1e3:8.1f} us  "
            f"x{layers}/frame on {path}  [{CARD}]")
    del wd
    return rows


def check_mxu_kernels(params, cfg, gen):
    """Phase 3 (sts_mxu, lm_split): K10 at B = 1 and B = POOL_B, K12 in
    both forms."""
    rows = check_k10(cfg, gen, 1)
    rows += check_k10(cfg, gen, POOL_B)
    rows += check_k12(params, cfg, gen)
    return rows


def _mxu_controls():
    """(name, context manager) of the controls of a frame comparison under
    the knobs: the CPU side with one of K10's pins changed, K3 in K10's
    place, or K1's control.  K12's forms differ from K1 in the f32 order
    of a sum alone: no frame reading can tell them apart (phase 3 holds
    them)."""
    from moshi_tpu_torch.nn import decode_attention as da
    return [("K10 p.v in f32", lambda: swapped(da, "_pv_round", lambda t: t)),
            ("K10 scale after the sum", lambda: swapped(
                da, "_scores_query", lambda qf, scale: (qf, scale))),
            ("K3 in K10's place", lambda: env_set("MOSHI_TPU_ATTN_MXU",
                                                  "0")),
            ("K1 bf16 partials", k1_control)]


# the frame controls held above transformer_out's RMS limit
_MXU_HELD = ("K10 p.v in f32", "K10 scale after the sum",
             "K3 in K10's place", "K1 bf16 partials")


def _frame_rms(card, cpu):
    """The largest over frames of ``rms_rel`` of transformer_out, the text
    logits and the depformer's logits (where the model has them)."""
    out = {}
    for key, name in (("h", "transformer_out"), ("logits", "logits"),
                      ("dep_logits", "dep_logits")):
        if cpu[0][key] is not None:
            out[name] = max(rms_rel(a[key], c[key])
                            for a, c in zip(card, cpu))
    return out


@reused_plain_weights()
def compare_mxu_two_layers():
    """Phase 4 (sts_mxu, lm_split): 2 layers of the 7B geometry under the
    sts_mxu knobs, card against CPU, for SEEDS_2L weight seeds, fresh and
    on a full ring; then one seed on a full ring under lm_split.  Each
    frame's CPU run starts from the card's delay cache; the decided
    tokens must agree, the largest errors stay within mxu_2l /
    mxu_2l_dep, and transformer_out's RMS (``_frame_rms``) within
    mxu_2l_rms, above which each control in ``_MXU_HELD`` must read.  The
    controls run on the first seed's full ring."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = lm.LMConfig(delays=_7B_DELAYS, num_layers=2)
    tol, tol_dep = TOL["mxu_2l"], TOL["mxu_2l_dep"]
    tol_rms = TOL["mxu_2l_rms"]
    readings, controls = [], {}
    runs = [("sts_mxu", s, label) for s in range(SEEDS_2L)
            for label in ("fresh", "full ring")]
    runs.append(("lm_split", 0, "full ring"))
    for path, s, label in runs:
        params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 1 + s)
        params_cpu = tree_to(params, "cpu")
        gen = torch.Generator().manual_seed(SEED + 400 + s)
        others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                                generator=gen) for _ in range(FRAMES_2L)]
        state = None
        if label == "full ring":
            state = long_session_state(cfg, torch.Generator(
                device=DEV).manual_seed(SEED + 410 + s))
        with knobs(path):
            card = _session(cfg, params, others, DEV, state=state)
            caches = [r["cache"] for r in card]
            cpu = _session(cfg, params_cpu, others, "cpu", caches,
                           state=state)
            r = dict(_compare(card, cpu, tol, tol_dep, decided_only=True),
                     seed=SEED + 1 + s, state=label, path=path,
                     rms=_frame_rms(card, cpu))
            readings.append(r)
            log(f"  {path}, seed {SEED + 1 + s}, {label}: {_show(r)}; "
                f"RMS {_show_rms(r['rms'])}")
            if path == "sts_mxu" and s == 0 and label == "full ring":
                for name, ctx in _mxu_controls():
                    with ctx():
                        ctl = _session(cfg, params_cpu, others, "cpu",
                                       caches, state=state)
                    controls[name] = dict(
                        _compare(ctl, cpu, tol, tol_dep, decided_only=True),
                        rms=_frame_rms(ctl, cpu))
                    log(f"  {path}, control ({name}) against the CPU: "
                        f"{_show(controls[name])}; RMS "
                        f"{_show_rms(controls[name]['rms'])}")
    for r in readings:
        if not (r["passes"] and r["rms"]["transformer_out"] <= tol_rms):
            fail(f"2-layer frame, {r['path']}, seed {r['seed']}, "
                 f"{r['state']}: card and CPU differ beyond {tol:g} "
                 f"(depformer {tol_dep:g}; transformer_out's RMS "
                 f"{tol_rms:g}) or in a decided token: {_show(r)}; RMS "
                 f"{_show_rms(r['rms'])}")
    for name in _MXU_HELD:
        if not controls[name]["rms"]["transformer_out"] > tol_rms:
            fail(f"2-layer frame, sts_mxu: the control ({name}) reads "
                 f"transformer_out's RMS "
                 f"{controls[name]['rms']['transformer_out']:.3e}, within "
                 f"{tol_rms:g}: it cannot tell that rounding apart")
    return {"frames": FRAMES_2L, "readings": readings, "controls": controls,
            "held": list(_MXU_HELD), "tol_rel": tol, "tol_dep_rel": tol_dep,
            "tol_rms": tol_rms}


def _show_rms(r):
    return ", ".join(f"{k} {v:.2e}" for k, v in r.items())


# ---------------------------------------------------------------------------
# the fp8 paths (LMConfig.kv_dtype "float8_e4m3fn"): sts_fp8 (the 7B STS
# frame: K3 and K4 on fp8 rings), pool_fp8 (the B = POOL_B SessionPool on
# fp8 rings) and stt_fp8 (the STT frame: K9 and K11 on fp8 rings)
# ---------------------------------------------------------------------------

def fp8_config(cfg):
    """``cfg`` with its temporal KV rings in float8_e4m3fn."""
    return dataclasses.replace(cfg, kv_dtype=FP8)


def fp8_launches(per_frame, temporal: int):
    """A bf16 path's launches per frame on fp8 rings: ``temporal`` of its
    K3 launches (the temporal stack's) and its K4 take their fp8 forms,
    and so do all of its K9 and K11 (the STT's generic stack); the
    depformer's rings stay bf16."""
    out = dict(per_frame)
    moved = {"decode_attention": temporal,
             "ring_write": out.get("ring_write", 0),
             "decode_attention4": out.get("decode_attention4", 0),
             "ring_write4": out.get("ring_write4", 0)}
    for name, n in moved.items():
        if n:
            out[name] -= n
            out[f"{name}_fp8"] = n
    return {k: v for k, v in out.items() if v}


def fp8_probe():
    """f32 values at every e4m3 value and every tie between two of them
    (and the f32 values on either side of it), subnormals, 448, 464 and
    its neighbours, 465, 480, 1e6, inf and NaN, both signs."""
    v = torch.arange(0x7F, dtype=torch.uint8).view(torch.float8_e4m3fn) \
        .float()
    mid = (v[:-1] + v[1:]) / 2
    up = torch.nextafter(mid, torch.full_like(mid, float("inf")))
    down = torch.nextafter(mid, torch.zeros_like(mid))
    near = torch.nextafter(torch.tensor([464.0]), torch.tensor([1e9]))
    edge = torch.tensor([448, 449, 463.99, 464, float(near), 465, 480, 1e6,
                         float("inf"), float("nan"), 2.0 ** -9, 2.0 ** -10,
                         3 * 2.0 ** -11, 1e-30, 0.0])
    # the edges first, so that a row too short for every value holds them
    return torch.cat([edge, -edge, v, -v, mid, -mid, up, -up, down, -down])


def fp8_rows(shape, gen):
    """f32 rows of ``shape`` on the card: the probe in shuffled places (as
    much of it as fits: all of it at the paths' shapes), N(0, 8) values
    elsewhere."""
    x = torch.randn(shape, generator=gen, device=DEV).flatten() * 8
    probe = fp8_probe().to(DEV)[:x.numel()]
    place = torch.randperm(x.numel(), generator=gen,
                           device=DEV)[:probe.numel()]
    x[place] = probe
    return x.reshape(shape)


def fp8_ring(shape, gen):
    """An fp8 ring of ``shape`` on the card: N(0, 1) values by the
    reference's cast, drawn one leading slice at a time (an f32 draw of a
    whole pool's rings at once would take 12 GiB)."""
    from moshi_tpu_torch.nn.ring import fp8_cast
    ring = torch.empty(shape, dtype=torch.float8_e4m3fn, device=DEV)
    for i in range(shape[0]):
        ring[i].copy_(fp8_cast(torch.randn(shape[1:], generator=gen,
                                           device=DEV)))
    return ring


def _check_fp8_write(what, run_kernel, run_plain, rings, rows):
    """K4 or K11 on fp8 rings against its plain version, bit for bit, NaN
    included, from f32 rows and from bf16 ones; the card's cast rule
    against the CPU's on the same rows; and the control: a saturating cast
    (the rule on the rows clamped to ±448, as PyTorch's CPU cast
    saturates), which must differ where |x| > 464.  Also counts where
    PyTorch's own ``.to(float8_e4m3fn)`` on the rows' device differs from
    the rule.  ``run_kernel(rings, rows)`` / ``run_plain`` write in place.
    Returns (saturating differences, PyTorch's own differences)."""
    from moshi_tpu_torch.nn.ring import fp8_cast, ring_bytes
    nan = 0
    for src in (rows, rows.to(torch.bfloat16)):
        got = [r.clone() for r in rings]
        ref = [r.clone() for r in rings]
        run_kernel(got, src)
        run_plain(ref, src)
        sync()
        for g, r in zip(got, ref):
            if not torch.equal(ring_bytes(g), ring_bytes(r)):
                fail(f"{what}: kernel and plain version differ "
                     f"({src.dtype} rows)")
            # slice by slice: a whole pool's rings at once would make a
            # 25 GB int64 temporary
            nan += sum(int(((x & 0x7F) == 0x7F).sum())
                       for x in ring_bytes(g))
        del got, ref
    cast = ring_bytes(fp8_cast(rows)).cpu()
    if not torch.equal(cast, ring_bytes(fp8_cast(rows.cpu()))):
        fail(f"{what}: the cast rule differs between the card and the CPU")
    sat = int((ring_bytes(fp8_cast(rows.clamp(-448, 448))).cpu()
               != cast).sum())
    own = int((ring_bytes(rows.to(torch.float8_e4m3fn)).cpu()
               != cast).sum())
    if not (nan and sat):
        fail(f"{what}: the probe wrote no NaN ({nan}) or the saturating "
             f"control wrote the same bits ({sat} differ)")
    return sat, own


def check_fp8_kernels(cfg, scfg, gen, batch: int):
    """Phase 9 (fp8), kernels at their paths' shapes on fp8 rings: K4 into
    the 7B temporal rings of all the layers (B = 1, and B = ``batch`` at
    ``pool_offsets``' slots: 6.3 GB of rings) and K11 into the stt-1b ring, bit for bit on probe rows
    (``_check_fp8_write``); K3 over the 7B temporal ring when full (B = 1)
    and at ``batch`` session ages, K9 over the stt-1b ring in its three
    states, each against its plain version at its bf16 instance's limit
    with the same controls (p in f32; K3's mask for K9 on the wrapped
    ring).  Each timed beside its plain version and one library call: the
    ring widened with ``.to(bf16)`` then SDPA, or ``.to(fp8)`` then
    ``index_copy_`` (through uint8 views: PyTorch has no indexed copy for
    fp8)."""
    from moshi_tpu_torch.nn import decode_attention as da
    from moshi_tpu_torch.nn import ring as rw
    from moshi_tpu_torch.nn.ring import ring_bytes
    bf = torch.bfloat16
    rows = []
    m = cfg.transformer.mha
    nl, row = cfg.num_layers, m.num_heads * m.head_dim

    # K4: the temporal rings at B = 1 and B = batch, every layer: one call
    # writes them all
    for b, key, slots in (
            (1, "calls_per_fp8_frame", [123 % m.cap]),
            (batch, "calls_per_fp8_tick",
             [o % m.cap for o in pool_offsets(m.cap, batch)])):
        layers = nl
        shape = (layers, b, m.cap, m.num_heads, m.head_dim)
        rings = [fp8_ring(shape, gen), fp8_ring(shape, gen)]
        ks = fp8_rows((layers, b, m.num_heads, m.head_dim), gen)
        vs = fp8_rows((layers, b, m.num_heads, m.head_dim), gen)
        slot = torch.tensor(slots, dtype=torch.int32, device=DEV)
        sat, own = _check_fp8_write(
            f"ring_write_fp8 B={b}",
            lambda r, x: rw.ring_write_stacked(r[0], r[1], x, vs.to(x.dtype),
                                               slot),
            lambda r, x: rw.ring_write_plain(r[0], r[1], x, vs.to(x.dtype),
                                             slot),
            rings, ks)
        k_ring, v_ring = rings

        def run_lib(i):
            idx = slot.long()
            k8 = ring_bytes(ks.to(torch.float8_e4m3fn))
            v8 = ring_bytes(vs.to(torch.float8_e4m3fn))
            if b == 1:
                ring_bytes(k_ring).index_copy_(2, idx, k8[:, :, None])
                ring_bytes(v_ring).index_copy_(2, idx, v8[:, :, None])
            else:                        # one slot per session
                bi = torch.arange(b, device=DEV)
                ring_bytes(k_ring)[:, bi, idx] = k8
                ring_bytes(v_ring)[:, bi, idx] = v8

        t_k = time_ms(lambda i: rw.ring_write_stacked(k_ring, v_ring, ks, vs,
                                                      slot), REPS)
        t_p = time_ms(lambda i: rw.ring_write_plain(k_ring, v_ring, ks, vs,
                                                    slot), REPS)
        t_l = time_ms(run_lib, REPS)
        nb = 2 * ks.numel() * (4 + 1)       # f32 rows read, fp8 written
        b_ms, _ = bound_ms(nb, 0.0, "f32")
        rows.append({
            "kernel": "ring_write_fp8", "shape": f"B={b} temporal rings",
            "L": layers, "B": b, "cap": m.cap, "slots": slots,
            "calls_per_frame": 0, key: 1, "max_abs_err": 0.0,
            "max_rel_err": 0.0, "tol_rel": 0.0, "saturating_control": sat,
            "torch_cast_differs": own, "ms": t_k, "plain_ms": t_p,
            "library_ms": t_l, "bound_ms": b_ms, "bound_by": "bytes",
            "bytes": nb})
        log(f"  ring_write_fp8  B={b} temporal rings {tuple(shape)}: exact, "
            f"NaN in place (control: a saturating cast differs on {sat}; "
            f"PyTorch's own .to() here on {own})  "
            f"{t_k * 1e3:8.1f} us  bound {b_ms * 1e3:6.2f} us  plain "
            f"{t_p * 1e3:8.1f} us  .to(fp8) + index copy {t_l * 1e3:7.1f} us"
            f"  [{CARD}]")
        del rings, k_ring, v_ring

    # K3: the temporal ring, full at B = 1, at batch ages at B = batch
    for b, key, label, offs in (
            (1, "calls_per_fp8_frame", "temporal, full ring",
             [m.cap + 7]),
            (batch, "calls_per_fp8_tick", f"B={batch} temporal, 8 ages",
             pool_offsets(m.cap, batch))):
        layers = nl if b == 1 else 2
        shape = (layers, b, m.cap, m.num_heads, m.head_dim)
        k_ring, v_ring = fp8_ring(shape, gen), fp8_ring(shape, gen)
        cur = [[torch.randn((b, m.num_heads, m.head_dim), generator=gen,
                            device=DEV).to(bf) for _ in range(3)]
               for _ in range(DRAWS)]
        offset = torch.tensor(offs, dtype=torch.int32, device=DEV)

        def run_kernel(i, d=0):
            c = cur[d]
            return da.decode_attention_stacked(
                c[0], k_ring, v_ring, c[1], c[2], offset, i % layers,
                cap=m.cap, context=cfg.context)

        def run_plain(i, d=0):
            c = cur[d]
            return da.decode_attention_plain(
                c[0], k_ring[i % layers], v_ring[i % layers], c[1], c[2],
                offset, cap=m.cap, context=cfg.context,
                chunk=da.chunk_for(m.cap))

        def run_lib(i):
            kk = k_ring[i % layers].to(bf).transpose(1, 2)
            vv = v_ring[i % layers].to(bf).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                cur[0][0][:, :, None], kk, vv)

        # the bf16 instance on the rings widened (exact): the same scores
        # and p, the value pass's partial sums in other groups
        k_wide, v_wide = k_ring.to(bf), v_ring.to(bf)
        max_err = max_rel = widen = rule = 0.0
        ctls, ctl_rule = [0.0] * DRAWS, [0.0] * DRAWS
        tol = TOL["decode_attention"]
        for lyr in (0, layers - 1):
            for d in range(DRAWS):
                c = cur[d]
                got, ref = run_kernel(lyr, d), run_plain(lyr, d)
                bound = flip_bound(c[0], k_ring[lyr], v_ring[lyr], offset,
                                   cap=m.cap, context=cfg.context,
                                   cur_k=c[1])
                max_err = max(max_err, float((got - ref).abs().max()))
                max_rel = max(max_rel, rel_err(got, ref))
                rule = max(rule, flip_score(got, ref, bound, tol))
                widen = max(widen, rel_err(got, da.decode_attention_stacked(
                    c[0], k_wide, v_wide, c[1], c[2], offset, lyr,
                    cap=m.cap, context=cfg.context)))
                with swapped(da, "_bf16_round", lambda t: t):
                    out = run_plain(lyr, d)
                ctls[d] = max(ctls[d], rel_err(out, ref))
                ctl_rule[d] = max(ctl_rule[d],
                                  flip_score(out, ref, bound, tol))
        del k_wide, v_wide
        ctl = min(ctls)
        check_rule(f"decode attention fp8 ({label})", "decode_attention",
                   rule, min(ctl_rule))
        if not widen <= TOL["fp8_widen"]:
            fail(f"decode attention fp8 ({label}): {widen:.3e} from the bf16 "
                 f"instance on the rings widened, above "
                 f"{TOL['fp8_widen']:g}")
        t_k = time_ms(run_kernel, REPS)
        t_p = time_ms(run_plain, max(REPS // 4, 3))
        t_l = time_ms(run_lib, REPS)
        valid = sum(max(0, min(o, cfg.context - 1)) for o in offs)
        nb = valid * row * 2 + b * (3 * row * 2 + row * 4)
        b_ms = bound_ms(nb, 4.0 * (valid + b) * row, "f32")[0]
        blocks = attention_blocks(b, m, da.chunk_for(m.cap))
        rows.append({
            "kernel": "decode_attention_fp8", "shape": label, "B": b,
            "H": m.num_heads, "hd": m.head_dim, "cap": m.cap,
            "blocks_per_call": blocks, "offsets": offs, "calls_per_frame": 0, key: nl,
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "control_rel_err": ctl, "tol_rel": tol, "rule": rule,
            "control_rule": min(ctl_rule), "bf16_instance_rel_err": widen,
            "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
            "bound_by": "bytes", "bytes": nb})
        log(f"  decode_attention_fp8 {label:27s} rel_err={max_rel:.2e}, "
            f"rule {rule:.3f} (tol {tol:g}; control {ctl:.2e}, rule "
            f"{min(ctl_rule):.3f}; the bf16 instance on the rings widened "
            f"{widen:.1e})  "
            f"{t_k * 1e3:8.1f} us  bound {b_ms * 1e3:7.2f} us  plain "
            f"{t_p * 1e3:9.1f} us  .to(bf16) + sdpa {t_l * 1e3:7.1f} us  "
            f"{blocks} blocks  [{CARD}]")
        del k_ring, v_ring

    # K9 and K11: the stt-1b ring
    sm = scfg.transformer.mha
    cap, ctx, h, hd = sm.cap, scfg.context, sm.num_heads, sm.head_dim
    snl, srow = scfg.num_layers, h * hd
    kc, vc = fp8_ring((1, cap, h, hd), gen), fp8_ring((1, cap, h, hd), gen)
    qs = [torch.randn((1, h, hd), generator=gen, device=DEV)
          for _ in range(DRAWS)]
    for label, off in stt_ring_states(cap):
        offset = torch.tensor([off], dtype=torch.int32, device=DEV)

        def run_kernel(i):
            return da.decode_attention(qs[i % DRAWS], kc, vc, offset,
                                       cap=cap, context=ctx)

        def run_plain(i, **kw):
            kw.setdefault("context", ctx)
            return da.decode_attention4_plain(qs[i % DRAWS], kc, vc, offset,
                                              cap=cap, **kw)

        def run_lib(i):
            return torch.nn.functional.scaled_dot_product_attention(
                qs[i % DRAWS].to(bf)[:, :, None], kc.to(bf).transpose(1, 2),
                vc.to(bf).transpose(1, 2))

        controls = _k9_controls(da, run_plain, off, cap, ctx, False)
        max_err, max_rel, rule, smallest, rules, asserted, asserted_rule = \
            check_k9(f"decode_attention4_fp8 ({label})", run_kernel,
                     run_plain, controls, lambda d, offset=offset:
                     flip_bound(qs[d], kc, vc, offset, cap=cap, context=ctx))
        t_k = time_ms(run_kernel, REPS)
        t_p = time_ms(run_plain, max(REPS // 4, 3))
        t_l = time_ms(run_lib, REPS)
        valid = min(off + 1, ctx)
        nb = valid * srow * 2 + srow * 2 + srow * 4
        b_ms, b_by = bound_ms(nb, 4.0 * valid * srow, "f32")
        rows.append({
            "kernel": "decode_attention4_fp8", "shape": f"stt ring, {label}",
            "B": 1, "H": h, "hd": hd, "cap": cap, "offset": off,
            "calls_per_frame": 0,
            "calls_per_fp8_stt_frame": snl if label == "wrapped" else 0,
            "max_abs_err": max_err, "max_rel_err": max_rel,
            "control_rel_err": asserted, "controls": smallest, "rule": rule,
            "control_rule": asserted_rule, "control_rules": rules,
            "tol_rel": TOL["decode_attention4"], "ms": t_k, "plain_ms": t_p,
            "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nb, "blocks_per_call": k9_blocks(1, sm)})
        shown = ", ".join(f"{k} {v:.2e} (rule {rules[k]:.3f})"
                          for k, v in smallest.items())
        log(f"  decode_attention4_fp8 stt ring, {label:14s} (offset "
            f"{off:4d}) rel_err={max_rel:.2e}, rule {rule:.3f} (tol "
            f"{TOL['decode_attention4']:g}; controls: {shown})  "
            f"{t_k * 1e3:8.1f} us  bound {b_ms * 1e3:6.2f} us  plain "
            f"{t_p * 1e3:9.1f} us  .to(bf16) + sdpa {t_l * 1e3:7.1f} us  "
            f"{rows[-1]['blocks_per_call']} blocks  [{CARD}]")
    # K11: k and v of one layer in one launch, at an offset past the ring
    vals = fp8_rows((1, h, hd), gen)
    pos = torch.tensor([cap + cap // 3], dtype=torch.int32, device=DEV)
    sat, own = _check_fp8_write(
        "ring_write4_fp8",
        lambda r, x: rw.ring_write_kv(r[0], r[1], x, -x, pos),
        lambda r, x: rw.ring_write_kv_plain(r[0], r[1], x, -x, pos),
        [kc, vc], vals)
    rows.append(dict(
        k11_pair_row("stt ring, one layer", (kc, vc), [(vals, -vals)],
                     [pos], {"calls_per_fp8_stt_frame": snl}),
        saturating_control=sat, torch_cast_differs=own))
    log(f"  ring_write4_fp8 stt ring: NaN in place (control: a saturating "
        f"cast differs on {sat}; PyTorch's own .to() here on {own})")
    return rows


@contextlib.contextmanager
def fp8_rows_recorded(records, layers: int):
    """Inside the block every fp8 ring write of the plain versions (the
    CPU's) appends (ring name, index, its f32 rows) to ``records``: K4's
    [L, B, H, hd] rows, or K11's [B, H, hd] (k, then v, per layer of the
    generic stack)."""
    from moshi_tpu_torch.nn import ring
    plain, plain4 = ring.ring_write_plain, ring.ring_write4_plain
    calls = [0]

    def rec(k_stack, v_stack, ks, vs, slot):
        if k_stack.dtype == ring.FP8:
            idx = (slice(None), torch.arange(ks.shape[1]),
                   torch.remainder(slot.long(), k_stack.shape[2]).cpu())
            records.append(("k", idx, ks.float().cpu().clone()))
            records.append(("v", idx, vs.float().cpu().clone()))
        return plain(k_stack, v_stack, ks, vs, slot)

    def rec4(cache, values, slot):
        if cache.dtype == ring.FP8:
            layer = (calls[0] // 2) % layers
            name = "kv"[calls[0] % 2]
            calls[0] += 1
            idx = (layer, torch.arange(values.shape[0]),
                   torch.remainder(slot.long(), cache.shape[1]).cpu())
            records.append((name, idx, values.float().cpu().clone()))
        return plain4(cache, values, slot)

    with swapped(ring, "ring_write_plain", rec), \
            swapped(ring, "ring_write4_plain", rec4):
        yield


def _e4m3_intervals(a):
    """The f32 interval [lo, hi] that the reference's rule rounds to each
    e4m3 value of ``a`` (f32 values; ±0 one value): the midpoints to its
    neighbours, ±464 past ±448."""
    table = torch.arange(0x7F, dtype=torch.uint8).view(
        torch.float8_e4m3fn).float()
    table = torch.cat([-table.flip(0)[:-1], table])      # -448 .. 448
    mids = (table[1:] + table[:-1]) / 2
    lo = torch.cat([torch.tensor([-464.0]), mids])
    hi = torch.cat([mids, torch.tensor([464.0])])
    i = torch.searchsorted(table, a.contiguous()).clamp(max=table.numel() - 1)
    return lo[i], hi[i]


def _e4m3_truncated(x):
    """``x`` rounded toward zero to an e4m3 value (a control's rounding),
    as f32; |x| past 448 gives ±448."""
    table = torch.arange(0x7F, dtype=torch.uint8).view(
        torch.float8_e4m3fn).float()
    i = torch.searchsorted(table, x.abs().contiguous(), right=True) - 1
    return torch.sign(x) * table[i.clamp(min=0)]


def fp8_ring_check(card, cpu, records, tie):
    """The card's final fp8 rings against the CPU's (``{k, v}``) after the
    same frames from the same state, with the CPU's written rows
    ``records``: every element the frames did not write must be equal
    bit for bit, and every written element of the card must be the
    rule's rounding of a value within ``tie`` of the CPU's f32 value x,
    relative to the largest |x| of its write (the rows differ by the
    card's and the CPU's sums, so a rounding near a tie may flip, and
    only there).  Returns the reading: flips (elements whose values
    differ), their share of the written elements, the largest shift a
    flip needs, stray differences, whether the rule held, and the share
    that the control (the CPU's rows rounded to bf16 before the cast, a
    double rounding) flips and the largest shift that the rows truncated
    toward zero would need (the shift's control)."""
    from moshi_tpu_torch.nn.ring import fp8_cast, ring_bytes
    flips = written = ctl = stray = 0
    worst = ctl_shift = 0.0
    for name in ("k", "v"):
        a = ring_bytes(card[name])
        c = ring_bytes(cpu[name]).to(a.device)
        other = a != c
        for rname, idx, x in records:
            if rname != name:
                continue
            other[idx] = False
            ba, bc = a[idx].cpu(), c[idx].cpu()
            va = ba.view(torch.float8_e4m3fn).float()
            vc = bc.view(torch.float8_e4m3fn).float()
            written += x.numel()
            ctl += int((fp8_cast(x.to(torch.bfloat16)).float() != vc).sum())
            scale = float(x[x.isfinite()].abs().max())
            # the shift's control: the rows truncated toward zero instead
            # of rounded to nearest
            lo, hi = _e4m3_intervals(_e4m3_truncated(x))
            ctl_shift = max(ctl_shift, float(
                (torch.maximum(lo - x, x - hi).clamp(min=0) / scale)
                .nan_to_num(0.0).max()))
            # values that differ (+0 and -0 are one value)
            diff = (ba != bc) & ~((va == 0) & (vc == 0))
            n = int(diff.sum())
            if not n:
                continue
            flips += n
            lo, hi = _e4m3_intervals(va[diff])
            xv = x[diff]
            shift = torch.maximum(lo - xv, xv - hi).clamp(min=0) / scale
            worst = max(worst, float(shift.nan_to_num(float("inf")).max()))
        stray += int(other.sum())
    return {"flips": flips, "written": written,
            "flip_share": flips / max(written, 1), "worst_shift": worst,
            "stray": stray, "rule_holds": stray == 0 and worst <= tie,
            "control_flip_share": ctl / max(written, 1),
            "control_shift": ctl_shift}


def _show_rings(r):
    return (f"rings: {r['flips']} of {r['written']} written elements "
            f"flipped ({r['flip_share']:.2e}, largest shift "
            f"{r['worst_shift']:.2e}, {r['stray']} stray); controls: rows "
            f"through bf16 flip {r['control_flip_share']:.2e}, truncation "
            f"needs a shift of {r['control_shift']:.2e}")


@reused_plain_weights()
def _fp8_check(what, cfg, params, others, state, tol, tol_dep, controls,
               tie, hold_share=True, tol_vad=0.0):
    """fp8 frames on the card against the CPU on the same weights, inputs
    and starting ``state`` (None: a fresh session), the CPU following the
    card's delay cache and tokens: the frames' ``_compare`` reading
    (decided tokens) within ``tol`` / ``tol_dep`` / ``tol_vad``, the rings
    by ``fp8_ring_check`` with ``tie`` and, with ``hold_share``, the
    flips' share within ``TOL["fp8_flips"]``, which the rows-through-bf16
    control must exceed; and each of ``controls`` (the CPU with one
    rounding changed) against the CPU, which must fail the frames'
    limits.  Fatal on any failure.  Logs the seconds each part took (the
    CPU's sessions take most of the phase)."""
    records, kept_card, kept_cpu = [], {}, {}
    t0 = time.perf_counter()
    card = _session(cfg, params, others, DEV, state=state, keep=kept_card)
    caches = [r["cache"] for r in card]
    params_cpu = tree_to(params, "cpu")
    t1 = time.perf_counter()
    with fp8_rows_recorded(records, cfg.num_layers):
        cpu = _session(cfg, params_cpu, others, "cpu", caches, state=state,
                       keep=kept_cpu, follow=card)
    t2 = time.perf_counter()
    r = _compare(card, cpu, tol, tol_dep, tol_vad, decided_only=True)
    rings = fp8_ring_check(kept_card["state"]["transformer"],
                           kept_cpu["state"]["transformer"], records, tie)
    ctl = {}
    for name, ctx in controls:
        with ctx():
            frames = _session(cfg, params_cpu, others, "cpu", caches,
                              state=state, follow=card)
        ctl[name] = _compare(frames, cpu, tol, tol_dep, tol_vad,
                             decided_only=True)
    del params_cpu, kept_card, kept_cpu
    secs = {"card": t1 - t0, "cpu": t2 - t1,
            "controls": time.perf_counter() - t2}
    log(f"  {what}: {_show(r)}; {_show_rings(rings)}  [card {secs['card']:.1f}"
        f" s, CPU {secs['cpu']:.1f} s, its controls {secs['controls']:.1f} s]")
    for name, c in ctl.items():
        log(f"    control ({name}) against the CPU: {_show(c)}")
    if not r["passes"]:
        fail(f"{what}: card and CPU differ beyond {tol:g} (depformer "
             f"{tol_dep:g}) or in a decided token: {_show(r)}")
    if not rings["rule_holds"]:
        fail(f"{what}: the fp8 rings break the flip rule (shift {tie:g}): "
             f"{_show_rings(rings)}")
    if rings["control_shift"] <= tie:
        fail(f"{what}: the truncating control needs no shift beyond {tie:g}: "
             f"the check cannot tell that rounding apart")
    if hold_share:
        if rings["flip_share"] > TOL["fp8_flips"]:
            fail(f"{what}: the fp8 rings flip more than "
                 f"{TOL['fp8_flips']:g}: {_show_rings(rings)}")
        if rings["control_flip_share"] <= TOL["fp8_flips"]:
            fail(f"{what}: the rows-through-bf16 control flips no more "
                 f"than {TOL['fp8_flips']:g} of the ring: the check cannot "
                 f"tell that rounding apart")
    for name, c in ctl.items():
        if c["passes"]:
            fail(f"{what}: the control ({name}) passes the check: it cannot "
                 f"tell that rounding apart")
    return dict(r, rings=rings, controls=ctl, tol_rel=tol,
                tol_dep_rel=tol_dep, seconds=secs)


def compare_fp8(full_cfg, full_params, scfg_full, batch: int):
    """Phase 9 (fp8), card against CPU on fp8 rings (``_fp8_check``): 2
    layers of the 7B geometry for SEEDS_FP8 weight seeds, each from a
    full ring FRAMES_FP8 // 2 positions before its wrap, so that the
    frames wrap it; 2 layers at B = ``batch`` for FRAMES_FP8_POOL ticks
    from ``pool_offsets``' ages (the one at cap - 1 wraps in the run,
    two wrapped before); all 32 layers of the 7B for FRAMES_32L_FP8
    frames of a long session (``long_session_state``: every layer reads
    its whole fp8 window); 2 layers of the stt-1b geometry from before
    its wrap.  One control each, on the first seed: K1's bf16 partials
    (the 7B at B = 1), K3's p in f32 (the pool), K9's p in f32 (the
    STT).  The CPU's sessions take most of the phase's time."""
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    out = {}
    cfg = fp8_config(dataclasses.replace(full_cfg, num_layers=2))
    cap = cfg.transformer.mha.cap
    frame_ctl = [c for c in _frame_controls("1") if c[0] != "K5 h_mid in bf16"]
    out["two_layer"] = []
    for s in range(SEEDS_FP8):
        params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 40 + s)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 240 + s)
        state = pool_state(cfg, 1, gen, [cap - FRAMES_FP8 // 2])
        cgen = torch.Generator().manual_seed(SEED + 140 + s)
        others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                                generator=cgen) for _ in range(FRAMES_FP8)]
        out["two_layer"].append(_fp8_check(
            f"fp8 2-layer frames, seed {SEED + 40 + s}", cfg, params, others,
            state, TOL["fp8_2l"], TOL["fp8_2l_dep"],
            frame_ctl[:1] if s == 0 else [], TOL["fp8_shift"]))
        del params, state
    params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 42)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 242)
    cgen = torch.Generator().manual_seed(SEED + 142)
    others = [torch.randint(0, cfg.card, (batch, cfg.n_q - cfg.dep_q),
                            generator=cgen) for _ in range(FRAMES_FP8_POOL)]
    out["pool_two_layer"] = _fp8_check(
        f"fp8 2-layer frames at B={batch}", cfg, params, others,
        pool_state(cfg, batch, gen),
        TOL["fp8_pool_2l"], TOL["fp8_pool_2l_dep"], _pool_controls()[:1],
        TOL["fp8_shift"])
    del params
    cfg32 = fp8_config(full_cfg)
    cgen = torch.Generator().manual_seed(SEED + 143)
    others = [torch.randint(0, cfg32.card, (1, cfg32.n_q - cfg32.dep_q),
                            generator=cgen) for _ in range(FRAMES_32L_FP8)]
    state = long_session_state(
        cfg32, torch.Generator(device=DEV).manual_seed(SEED + 243))
    out["full_depth"] = _fp8_check(
        f"fp8 {cfg32.num_layers}-layer frames, full window", cfg32,
        full_params, others, state, TOL["fp8_32l"], TOL["fp8_32l_dep"],
        frame_ctl[:1], TOL["fp8_shift_32l"], hold_share=False)
    del state
    scfg = fp8_config(dataclasses.replace(scfg_full, num_layers=2))
    scap = scfg.transformer.mha.cap
    out["stt_two_layer"] = []
    for s in range(SEEDS_FP8):
        sparams = synth_lm_params(scfg, None, device=DEV, seed=SEED + 44 + s)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 244 + s)
        out["stt_two_layer"].append(_fp8_check(
            f"fp8 STT 2-layer frames, seed {SEED + 44 + s}", scfg, sparams,
            _stt_others(scfg, FRAMES_FP8, SEED + 144 + s),
            pool_state(scfg, 1, gen, [scap - FRAMES_FP8 // 2]),
            TOL["fp8_stt_2l"], 0.0, _stt_controls()[:1] if s == 0 else [],
            TOL["fp8_shift"], tol_vad=TOL["stt_vad"]))
        del sparams
    return out


def fp8_floor_ms(rows, label, nl: int):
    """The 7B frame's HBM floor on fp8 rings: the bf16 frame's
    (``hbm_floor_ms`` with the temporal attention ``label``) with the
    temporal K3's ring reads halved and K4 reading f32 rows and writing
    fp8 (4 + 1 bytes an element for the copy's 2 + 2)."""
    k3 = next(r for r in rows if r["kernel"] == "decode_attention"
              and r["shape"] == label)
    k4 = next(r for r in rows if r["kernel"] == "ring_write"
              and r.get("calls_per_frame"))
    row = k3["H"] * k3["hd"]
    ring_read = k3["bytes"] - 3 * row * 2 - row * 4
    delta = -ring_read / 2 * nl + k4["bytes"] / 4
    return hbm_floor_ms(rows, label, nl) + delta / HBM_BYTES_PER_S * 1e3


def fp8_memory(cfg, weight_bytes, pool_bf16, pool_fp8):
    """KV bytes per session and auto_slots for both ring dtypes, and the
    pools' peak over the memory live before them per session's rings
    (``memory.KV_TRANSIENT``'s reading): fatal where a reading exceeds
    the constant, since ``auto_slots`` would then overcommit."""
    from moshi_tpu_torch.runtime import memory
    from moshi_tpu_torch.runtime.serving import auto_slots
    out = {}
    for name, c, pool in (("bf16", cfg, pool_bf16),
                          ("fp8", fp8_config(cfg), pool_fp8)):
        kv = memory.kv_bytes_per_session(c)
        on_card = DEV == "cuda"
        sessions = memory.suggest_sessions(c, weight_bytes) if on_card else 0
        slots = auto_slots(c, weight_bytes) if on_card else 0
        out[name] = {"kv_bytes_per_session": kv, "auto_slots": slots,
                     "suggest_sessions": sessions,
                     "kv_transient": pool["kv_transient"],
                     "pool_peak_over_before": (pool["peak_memory_bytes"]
                                               - pool["live_before_bytes"])}
        log(f"  {name} rings: {kv / 1e9:.4f} GB KV per session, "
            f"suggest_sessions {sessions}, auto_slots {slots} (its cap 64; "
            f"weights {weight_bytes / 1e9:.3f} GB); the B="
            f"{pool['batch']} pool's peak over the live memory "
            f"{out[name]['pool_peak_over_before'] / 2 ** 30:.3f} GiB, "
            f"factor {pool['kv_transient']:.4f} (KV_TRANSIENT "
            f"{memory.KV_TRANSIENT:g})  [{CARD}]")
        if DEV == "cuda" and pool["kv_transient"] > memory.KV_TRANSIENT:
            fail(f"{name} pool: its peak over the live memory is "
                 f"{pool['kv_transient']:.4f} x its KV rings, above "
                 f"KV_TRANSIENT {memory.KV_TRANSIENT:g}: auto_slots would "
                 f"overcommit")
    return out


# ---------------------------------------------------------------------------
# phase 10: the last two kernel forms, K1 and K5 on unpacked-i8 weight
# storage (sts_i8) and K13 on fp8 flat rings (sts_mega_fp8)
# ---------------------------------------------------------------------------

def i8_launches(per_frame):
    """A path's launches per frame on unpacked-i8 weights: K1 and K5 take
    their i8 forms (the 7B's one q4_0 weight, the depformer linear_out, is
    left packed by ``i8_storage_tree`` and stays on K2)."""
    out = dict(per_frame)
    for name in ("int8_matvec", "attn_ffn_fused"):
        if out.get(name):
            out[f"{name}_i8"] = out.pop(name)
    return out


def mega_fp8_launches(cfg):
    """``mega_launches`` with K13 in its fp8 form (the depformer's rings,
    K14c's, stay bf16)."""
    out = mega_launches(cfg)
    out["temporal_full_step_fp8"] = out.pop("temporal_full_step")
    return out


def _as_i8_path(rows, kernel):
    """Check rows of the packed path's kernels relabelled as the sts_i8
    path's ``kernel``: their calls per frame become the path's."""
    for r in rows:
        r.update(kernel=kernel, calls_per_i8_frame=r["calls_per_frame"],
                 calls_per_frame=0, calls_per_frame_unfused=0,
                 calls_per_mxu_frame=0, calls_per_split_frame=0)
    return rows


def check_i8_kernels(params, iparams, cfg, gen):
    """Phase 10 (sts_i8): K1 on i8 storage at every product the frame gives
    it (``check_matvecs``' cases with calls in the fused form; K1's limit
    and control), and on a synthesized q4_0 weight at the 7B's out_proj
    shape (the scale-only epilogue, whose zero point is in the values); K5
    with both groups unpacked at the temporal and the depformer shapes
    (``check_fused``); then every K1 and K5 output on q4_k against the
    packed storage's kernel on the same inputs, which must be equal bit
    for bit (the same integer dots, the same epilogue), each product
    timed in both storages."""
    from moshi_tpu_torch.quant import fused
    from moshi_tpu_torch.quant import matmul_int8 as mi
    from moshi_tpu_torch.quant.formats import i8_storage
    from moshi_tpu_torch.runtime.synth import synth_quant_tensor
    cases = [c for c in _matvec_cases(iparams, cfg)
             if c[6] and i8_storage(c[1])]
    rows = _as_i8_path(check_matvecs(iparams, cfg, gen, cases),
                       "int8_matvec_i8")
    packed = {c[0]: c[1] for c in _matvec_cases(params, cfg)}
    for r, (name, qt, layers, xdt, alpha, glu, _, _) in zip(rows, cases):
        k = qt.shape[-1]
        xs = [torch.randn((1, k), generator=gen, device=DEV).to(xdt)
              for _ in range(DRAWS)]
        fn = mi.glu_matmul_i8 if glu else mi.qmatmul_i8

        def run(i, w, layer=None):
            return fn(xs[i % DRAWS], w, layer=(i % layers) if layer is None
                      else layer, alpha=alpha)

        for lyr in sorted({0, layers - 1}):
            for d in range(DRAWS):
                if not torch.equal(run(d, qt, lyr), run(d, packed[name],
                                                        lyr)):
                    fail(f"K1 i8 {name}: not bit for bit the packed "
                         f"storage's output (layer {lyr}, draw {d})")
        # in turns: packed, i8, i8, packed
        t = [time_ms(lambda i, w=w: run(i, w), REPS)
             for w in (packed[name], qt, qt, packed[name])]
        r.update(packed_ms=(t[0] + t[3]) / 2, i8_turns_ms=(t[1] + t[2]) / 2,
                 equals_packed=True)
        log(f"    {name}: bit for bit the packed storage's output; in turns "
            f"packed {t[0] * 1e3:.1f}, i8 {t[1] * 1e3:.1f}, i8 "
            f"{t[2] * 1e3:.1f}, packed {t[3] * 1e3:.1f} us  [{CARD}]")
    # the scale-only epilogue: a q4_0 weight at the out_proj's shape
    dd = cfg.dim
    q40 = synth_quant_tensor("q4_0", (2,), dd, dd, torch.Generator(
        device=DEV).manual_seed(SEED + 50), DEV).with_i8_storage()
    rows += _as_i8_path(check_matvecs(iparams, cfg, gen, [(
        "q4_0 (synthesized)", q40, 2, torch.bfloat16, None, False, 0,
        0)]), "int8_matvec_i8")
    frows = _as_i8_path(check_fused(iparams, cfg, gen), "attn_ffn_fused_i8")
    lay, ilay = params["transformer"]["layers"], \
        iparams["transformer"]["layers"]
    dl, idl = params["depformer"]["layers"], iparams["depformer"]["layers"]
    nd = cfg.dep_q * cfg.depformer_layers
    for r, (out_w, glu_w, iout, iglu, alpha, layers, hdt) in zip(frows, (
            (lay["self_attn"]["out_proj"]["weight"],
             lay["gating"]["linear_in"]["weight"],
             ilay["self_attn"]["out_proj"]["weight"],
             ilay["gating"]["linear_in"]["weight"], lay["norm2"]["alpha"],
             cfg.num_layers, torch.float32),
            (dl["self_attn"]["out_proj"]["weight"],
             dl["gating"]["linear_in"]["weight"],
             idl["self_attn"]["out_proj"]["weight"],
             idl["gating"]["linear_in"]["weight"],
             dl["norm2"]["alpha"].repeat(cfg.dep_q, 1), nd,
             torch.bfloat16))):
        k = out_w.shape[-1]
        draws = [(torch.randn((1, k), generator=gen, device=DEV)
                  .to(torch.bfloat16),
                  torch.randn((1, k), generator=gen, device=DEV).to(hdt))
                 for _ in range(DRAWS)]
        for lyr in sorted({0, layers - 1}):
            for a, hc in draws:
                gi, hi = fused.attn_ffn_fused_i8(a, hc, iout, iglu, alpha,
                                                 lyr)
                gp, hp = fused.attn_ffn_fused_i8(a, hc, out_w, glu_w, alpha,
                                                 lyr)
                if not (torch.equal(gi, gp) and torch.equal(hi, hp)):
                    fail(f"K5 i8 ({r['shape']}): not bit for bit the packed "
                         f"storage's output (layer {lyr})")

        def run(i, o, g):
            a, hc = draws[i % DRAWS]
            return fused.attn_ffn_fused_i8(a, hc, o, g, alpha, i % layers)

        t = [time_ms(lambda i, o=o, g=g: run(i, o, g), REPS)
             for o, g in ((out_w, glu_w), (iout, iglu), (iout, iglu),
                          (out_w, glu_w))]
        r.update(packed_ms=(t[0] + t[3]) / 2, i8_turns_ms=(t[1] + t[2]) / 2,
                 equals_packed=True)
        log(f"    attn_ffn_fused {r['shape']}: bit for bit the packed "
            f"storage's output; in turns packed {t[0] * 1e3:.1f}, i8 "
            f"{t[1] * 1e3:.1f}, i8 {t[2] * 1e3:.1f}, packed "
            f"{t[3] * 1e3:.1f} us  [{CARD}]")
    return rows + frows


def compare_i8_frames(cfg, params, iparams, gen):
    """Phase 10 (sts_i8): the 32-layer frame on i8 storage against the
    packed frame on the card, FRAMES_I8 frames from the same long session
    at temp 0: transformer_out, the text and depformer logits and every
    token bit for bit (every i8 product is q4_k; the path's q4_0 weight
    stays packed)."""
    state = long_session_state(cfg, gen)
    cgen = torch.Generator().manual_seed(SEED + 150)
    others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                            generator=cgen) for _ in range(FRAMES_I8)]
    packed = _session(cfg, params, others, DEV, state=state)
    unpacked = _session(cfg, iparams, others, DEV, state=state)
    diff = [key for a, b in zip(unpacked, packed)
            for key in ("h", "logits", "dep_logits", "tokens")
            if not torch.equal(a[key], b[key])]
    r = _compare(unpacked, packed, 0.0, 0.0)
    # the same frames at the sampling defaults, each run drawing from a
    # generator of the same seed
    from moshi_tpu_torch.models import lm
    sampled = []
    for p in (params, iparams):
        st = _state_copy(state, DEV)
        sgen = torch.Generator(device=DEV).manual_seed(SEED + 151)
        outs = []
        for other in others:
            out, st = lm.lm_gen_step(cfg, p, st, other_audio=other.to(DEV),
                                     generator=sgen)
            outs.append(torch.cat([out["sampled_text"][:, None],
                                   out["audio"], out["text"][:, None]], 1))
        sampled.append(torch.stack(outs).cpu())
        del st
    del state
    same_sampled = torch.equal(sampled[0], sampled[1])
    log(f"  i8 against packed storage, {FRAMES_I8} frames of the "
        f"{cfg.num_layers}-layer frame from a full ring at temp 0: "
        f"{_show(r)}; bit for bit: {not diff}; at the sampling defaults "
        f"with the same generator, the same tokens: {same_sampled}  "
        f"[{CARD}]")
    if diff or not same_sampled:
        fail(f"sts_i8: the frames on i8 storage differ from the packed "
             f"storage's in {sorted(set(diff))} (temp 0; sampled tokens "
             f"equal: {same_sampled}): {_show(r)}")
    return dict(r, frames=FRAMES_I8, bit_for_bit=True,
                sampled_tokens_equal=True)


@contextlib.contextmanager
def flat_rows_recorded(records, cap: int):
    """Inside the block every fp8 row K13's plain version casts for its
    flat rings appends (ring name, (layer, slot), its f32 row) to
    ``records`` (``fp8_ring_check``'s form)."""
    from moshi_tpu_torch.nn import temporal
    from moshi_tpu_torch.nn.ring import FP8
    plain, cast = temporal.temporal_full_step_plain, temporal.to_ring_dtype

    def rec_plain(h, k_cache, v_cache, offset, *a, **kw):
        rows = []

        def rec_cast(x, dtype):
            if dtype == FP8:
                rows.append(x.float().cpu().clone())
            return cast(x, dtype)

        with swapped(temporal, "to_ring_dtype", rec_cast):
            out = plain(h, k_cache, v_cache, offset, *a, **kw)
        slot = int(offset) % cap
        for i, x in enumerate(rows):        # k, then v, per layer
            records.append(("kv"[i % 2], (i // 2, slot), x))
        return out

    with swapped(temporal, "temporal_full_step_plain", rec_plain):
        yield


def _fp8_flat_ring(shape, cap: int, gen):
    """A flat fp8 ring [L, cap_pad, dim]: N(0, 1) rows cast by the
    reference's rule in its first ``cap`` slots, zeros past them."""
    from moshi_tpu_torch.nn.ring import fp8_cast
    ring = torch.zeros(shape, dtype=torch.float8_e4m3fn, device=DEV)
    for i in range(shape[0]):
        ring[i, :cap].copy_(fp8_cast(torch.randn(
            (cap, shape[2]), generator=gen, device=DEV)))
    return ring


def _e4m3_steps(a, b):
    """How many e4m3 values lie between the elements of two fp8 tensors
    of one sign (0 where equal; NaN counts as equal to NaN only)."""
    ia, ib = a.view(torch.uint8).int(), b.view(torch.uint8).int()
    oa = torch.where(ia >= 0x80, -(ia & 0x7F), ia)
    ob = torch.where(ib >= 0x80, -(ib & 0x7F), ib)
    nan = ((ia & 0x7F) == 0x7F) | ((ib & 0x7F) == 0x7F)
    return torch.where(nan, torch.where(ia == ib, 0, 99), (oa - ob).abs())


def check_k13_fp8(params, cfg, gen):
    """Phase 10 (sts_mega_fp8): K13 on fp8 flat rings at the 7B's shapes
    (``check_k13``'s three: all 32 layers on a fresh ring and on a full
    one, 2 layers on the full one, where the attention's roundings are
    held), against its plain version at K13's limits with its controls;
    h against the bf16 instance on the rings widened (exact), which must
    be equal bit for bit; the fp8 rows it returns against the plain
    version's, each element the same e4m3 value or its neighbour (a flip
    at a tie of the rule) at 2 layers; and a probe (norm1 scaled so that
    the first layer's rows pass 464) whose rows must be NaN exactly where
    the plain version's are, where the rule clamped to ±448 (a saturating
    cast, the control) writes ±448."""
    from moshi_tpu_torch.nn import temporal as tm
    from moshi_tpu_torch.nn.ring import fp8_cast
    from moshi_tpu_torch.nn.rope import rope_angles
    tc = cfg.transformer
    dd, hidden, cap = tc.dim, tc.hidden_dim, tc.mha.cap
    cap_pad = tm.plan_stages(dd, hidden, cap)[5]
    rows = []
    nl = tc.num_layers
    every = ["weights in f32", "K13 p in f32", "K13 exact products"]
    for depth, label, off, calls, key, held in (
            (nl, f"{nl} layers, fresh fp8 ring", 0, 0, "temporal_full_step",
             every[:1]),
            (nl, f"{nl} layers, full fp8 ring", cap + 37, 1,
             "temporal_full_step_full", every),
            (2, "2 layers, full fp8 ring", cap + 37, 0,
             "temporal_full_step_2l", every)):
        w = _k13_weights(params, depth)
        shape = (depth, cap_pad, dd)
        if off:
            kc, vc = (_fp8_flat_ring(shape, cap, gen),
                      _fp8_flat_ring(shape, cap, gen))
        else:
            kc = torch.zeros(shape, dtype=torch.float8_e4m3fn, device=DEV)
            vc = torch.zeros_like(kc)
        kw16, vw16 = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
        pos = torch.tensor([off], dtype=torch.int32, device=DEV)
        cos_sin = rope_angles(pos, tc.mha.head_dim, tc.rope_max_period)
        hs = [torch.randn((1, dd), generator=gen, device=DEV)
              for _ in range(DRAWS)]
        kw = dict(cap=cap, context=tc.context, heads=tc.num_heads,
                  hidden=hidden, nlayers=depth)

        def run_kernel(i, rings=(kc, vc)):
            return tm.temporal_full_step(hs[i % DRAWS], *rings, pos,
                                         cos_sin, w, **kw)

        def run_plain(i):
            return tm.temporal_full_step_plain(hs[i % DRAWS], kc, vc, pos,
                                               cos_sin, w, **kw)

        names = every if off else every[:1]
        max_err = max_rel = 0.0
        steps = 0
        widened = True
        ctls = {n: [] for n in names}
        for d in range(DRAWS):
            got, ref = run_kernel(d), run_plain(d)
            if not torch.isfinite(got[0]).all():
                fail(f"K13 fp8 ({label}): non-finite kernel output")
            max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
            max_rel = max(max_rel, rel_err(got[0], ref[0]))
            widened &= torch.equal(got[0], run_kernel(d, (kw16, vw16))[0])
            for i in (1, 2):
                steps = max(steps, int(_e4m3_steps(got[i], ref[i]).max()))
            for name, ctx in mega_controls(names):
                with ctx():
                    ctls[name].append(rel_err(run_plain(d)[0], ref[0]))
        if not widened:
            fail(f"K13 fp8 ({label}): h differs from the bf16 instance's on "
                 f"the rings widened")
        if depth == 2 and steps > 1:
            fail(f"K13 fp8 ({label}): its fp8 rows are {steps} e4m3 steps "
                 f"from the plain version's")
        ctl = {n: min(v) for n, v in ctls.items()}
        _held(f"K13 fp8 ({label})", key, max_rel, ctl, held)
        t_k = time_ms(run_kernel, REPS)
        t_16 = time_ms(lambda i: run_kernel(i, (kw16, vw16)), REPS)
        t_p = time_ms(run_plain, 3)
        del kw16, vw16
        valid = min(cap - 1, tc.context - 1) if off else 0
        b_ms, b_by, nbytes = k13_bound(w, depth, valid, dd, hidden,
                                       tc.mha.head_dim, 1)
        rows.append({
            "kernel": "temporal_full_step_fp8", "shape": label,
            "layers": depth, "offset": off, "calls_per_frame": 0,
            "calls_per_mega_fp8_frame": calls, "max_abs_err": max_err,
            "max_rel_err": max_rel, "control_rel_err": min(
                ctl[n] for n in held), "controls": ctl,
            "bf16_instance_equal": widened, "rows_e4m3_steps": steps,
            "tol_rel": TOL[key], "ms": t_k, "bf16_instance_ms": t_16,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "blocks_per_call": k13_blocks(tc, True)})
        log(f"  temporal_full_step_fp8 {label:24s} rel_err={max_rel:.2e} "
            f"(tol {TOL[key]:g}, controls "
            + ", ".join(f"{n} {v:.2e}" for n, v in ctl.items())
            + f"); h bit for bit the bf16 instance's on the rings widened; "
            f"rows within {steps} e4m3 step(s)  {t_k:8.3f} ms (bf16 "
            f"instance {t_16:.3f})  bound {b_ms:6.3f} ms  plain "
            f"{t_p:8.3f} ms  {rows[-1]['blocks_per_call']} blocks  "
            f"[{CARD}]")
        del kc, vc

    # the probe: norm1 scaled so that the first layer's largest row
    # element reaches 2000, about a third of them past 464
    w = _k13_weights(params, 1)
    kc = torch.zeros((1, cap_pad, dd), dtype=torch.float8_e4m3fn,
                     device=DEV)
    pos = torch.tensor([5], dtype=torch.int32, device=DEV)
    cos_sin = rope_angles(pos, tc.mha.head_dim, tc.rope_max_period)
    h = torch.randn((1, dd), generator=gen, device=DEV)
    kw = dict(cap=cap, context=tc.context, heads=tc.num_heads,
              hidden=hidden, nlayers=1)
    rec = []
    cast = tm.to_ring_dtype

    def plain(weights):
        rec.clear()
        with swapped(tm, "to_ring_dtype",
                     lambda x, dt: (rec.append(x.float()), cast(x, dt))[1]):
            return tm.temporal_full_step_plain(h, kc, kc, pos, cos_sin,
                                               weights, **kw)

    plain(w)
    scale = 2000.0 / max(float(x.abs().max()) for x in rec)
    w["n1"] = (w["n1"].float() * scale).to(w["n1"].dtype)
    got = tm.temporal_full_step(h, kc, kc, pos, cos_sin, w, **kw)
    ref = plain(w)
    nan = sat = 0
    for g, r, x in zip(got[1:], ref[1:], rec):
        gn, rn = torch.isnan(g.float()), torch.isnan(r.float())
        if not torch.equal(gn, rn) or int(_e4m3_steps(g, r).max()) > 1:
            fail("K13 fp8 probe: its rows differ from the plain version's "
                 "beyond a flip at a tie, or in where they are NaN")
        nan += int(gn.sum())
        sat += int((fp8_cast(x.clamp(-448, 448)).view(torch.uint8)
                    != r.reshape(x.shape).view(torch.uint8)).sum())
    if not (nan and sat):
        fail(f"K13 fp8 probe: no NaN row element ({nan}), or the saturating "
             f"control writes the same bits ({sat} differ)")
    log(f"  temporal_full_step_fp8 probe (norm1 x {scale:.4g}): "
        f"{nan} row elements past 464 NaN as in the plain version; a "
        f"saturating cast differs on {sat}  [{CARD}]")
    rows[-1].update(probe_nan=nan, probe_saturating_control=sat)
    return rows


@reused_plain_weights()
def compare_mega_fp8_two_layers():
    """Phase 10 (sts_mega_fp8): 2 layers of the 7B geometry under
    MOSHI_TPU_MEGAKERNEL=all on fp8 flat rings, card against CPU, one
    weight seed, FRAMES_FP8 frames from a full ring FRAMES_FP8 // 2
    positions before its wrap: the frames within the megakernel frame's
    limits (``mega_2l``; the CPU following the card's tokens), and the
    rings by ``fp8_ring_check`` (the flip rule of phase 9, ``fp8_shift``
    and ``fp8_flips`` with their controls); the frame control K13's p in
    f32."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = fp8_config(lm.LMConfig(delays=_7B_DELAYS, num_layers=2))
    cap = cfg.transformer.mha.cap
    tol, tol_dep = TOL["mega_2l"], TOL["mega_2l_dep"]
    params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 60)
    params_cpu = tree_to(params, "cpu")
    gen = torch.Generator().manual_seed(SEED + 360)
    others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.dep_q),
                            generator=gen) for _ in range(FRAMES_FP8)]
    with megakernel("all"):
        state = lm.init_gen_state(cfg, 1, device="cpu", params=params_cpu)
        if state["transformer"]["k"].dim() != 3 or \
                state["transformer"]["k"].dtype != torch.float8_e4m3fn:
            fail("sts_mega_fp8: init_gen_state did not take the flat fp8 "
                 "layout")
        state = flat_long_session(cfg, state, gen)
        state["offset"].fill_(cap - FRAMES_FP8 // 2)
        kept_card, kept_cpu, records = {}, {}, []
        t0 = time.perf_counter()
        card = _mega_session(cfg, params, others, DEV, state, keep=kept_card)
        t1 = time.perf_counter()
        with flat_rows_recorded(records, cap):
            cpu = _mega_session(cfg, params_cpu, others, "cpu", state,
                                lead=card, keep=kept_cpu)
        t2 = time.perf_counter()
        with mega_controls(["K13 p in f32"])[0][1]():
            ctl = _mega_session(cfg, params_cpu, others, "cpu", state,
                                lead=card)
    r = _compare(card, cpu, tol, tol_dep, decided_only=True)
    c = _compare(ctl, cpu, tol, tol_dep, decided_only=True)
    rings = fp8_ring_check(kept_card["state"]["transformer"],
                           kept_cpu["state"]["transformer"], records,
                           TOL["fp8_shift"])
    log(f"  megakernels on fp8 rings, 2 layers across the wrap: {_show(r)}; "
        f"{_show_rings(rings)}  [card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s, "
        f"its control {time.perf_counter() - t2:.1f} s]")
    log(f"    control (K13 p in f32) against the CPU: {_show(c)}")
    if not r["passes"]:
        fail(f"2-layer megakernel frame on fp8 rings: card and CPU differ "
             f"beyond {tol:g} (depformer {tol_dep:g}) or in a decided token:"
             f" {_show(r)}")
    if c["passes"]:
        fail("2-layer megakernel frame on fp8 rings: the control (K13 p in "
             "f32) passes the check: it cannot tell that rounding apart")
    if not rings["rule_holds"] or rings["flip_share"] > TOL["fp8_flips"]:
        fail(f"2-layer megakernel frame on fp8 rings: the rings break the "
             f"flip rule: {_show_rings(rings)}")
    if rings["control_shift"] <= TOL["fp8_shift"] or \
            rings["control_flip_share"] <= TOL["fp8_flips"]:
        fail(f"2-layer megakernel frame on fp8 rings: a ring control passes "
             f"the flip rule: it cannot tell that rounding apart: "
             f"{_show_rings(rings)}")
    return dict(r, rings=rings, controls={"K13 p in f32": c}, tol_rel=tol,
                tol_dep_rel=tol_dep, frames=FRAMES_FP8)


# ---------------------------------------------------------------------------
# phase 7 (sts_scan, stt_scan, session): the offline scans and the
# streaming sessions
# ---------------------------------------------------------------------------

def _scan_audio(fs, n, seed):
    """A clip of ``n`` frames [n, 1, fs] of N(0, 0.1) audio on the card."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 1, fs), generator=gen) * 0.1).to(DEV)


def _acausal_bias(offset, t: int, cap: int, context: int):
    """``nn/attention.py`` ``streaming_attn_bias`` without its causal
    bound: each query also sees the later positions of its call.  The
    control of the offline Mimi checks: a T = 250 call whose mask lets a
    query see the chunk's future (a streaming T = 2 step would see one
    position more)."""
    from moshi_tpu_torch.nn.attention import NEG_BIAS, ring_key_positions
    last = offset.long() + (t - 1)
    p = ring_key_positions(last, cap)[:, None, :]
    qp = (offset.long()[:, None]
          + torch.arange(t, device=offset.device)[None, :])[:, :, None]
    valid = (p >= 0) & (p > qp - context)
    zero = torch.zeros((), dtype=torch.float32, device=offset.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_BIAS))


def acausal_mimi():
    """Mimi's T > 1 attention under ``_acausal_bias`` inside the block."""
    from moshi_tpu_torch.nn import attention
    return swapped(attention, "streaming_attn_bias", _acausal_bias)


def bypassed_mimi():
    """Mimi's transformers passed over inside the block (each returns its
    input): a path that dropped their output."""
    from moshi_tpu_torch.models import mimi
    return swapped(mimi, "transformer_forward",
                   lambda cfg, params, state, x, offset, cross_kv=None:
                   (x, state))


# the controls of the offline Mimi checks: the offline path with one
# fault of its transformers
_MIMI_CONTROLS = (("the T > 1 mask without its causal bound", acausal_mimi),
                  ("the transformers passed over", bypassed_mimi))


def code_share(got, ref):
    """The share of equal codes [B, N, n_q]: over every book, and over book
    0 (the semantic one, which the later books' residuals follow)."""
    eq = (got.cpu() == ref.cpu()).float()
    return float(eq.mean()), float(eq[..., 0].mean())


@contextlib.contextmanager
def recorded_quantizer(mimi, q_in):
    """Inside the block ``mimi``'s quantizer appends its input to
    ``q_in``."""
    encode = mimi.quantizer.encode

    def rec(p, x, n_q=None):
        q_in.append(x)
        return encode(p, x, n_q)

    with swapped(mimi.quantizer, "encode", rec):
        yield q_in


def hold_offline_codes(label, mparams, q_in, stream, offline, controls):
    """(a) of the scans: the offline codes against the streaming codes
    ``stream`` [B, N, n_q] (its quantizer input ``q_in``): every code the
    streaming quantizer decides (``decided_codes``) equal, and each
    control's offline codes (``controls``: name -> codes) differing in at
    least one decided code.  The share of all codes equal is logged."""
    n_q = stream.shape[-1]
    decided, agree = decided_codes(mparams, q_in, stream, offline, n_q)
    share = code_share(offline, stream)
    ctl = {}
    for name, codes in controls.items():
        d, a = decided_codes(mparams, q_in, stream, codes, n_q)
        ctl[name] = {"decided": d, "equal": a,
                     "share": code_share(codes, stream)}
    log(f"  {label}: offline codes against the streaming encode's: decided "
        f"(gap > {TOL['mimi_gap']:g}) {decided} of {stream.numel()}, equal "
        f"{agree}; all codes equal {share[0]:.4f}, book 0 {share[1]:.4f}; "
        f"controls: " + "; ".join(
            f"{k}: decided equal {v['equal']}/{v['decided']}, all "
            f"{v['share'][0]:.4f}, book 0 {v['share'][1]:.4f}"
            for k, v in ctl.items()))
    if agree != decided or decided < stream.shape[1]:
        fail(f"{label}: the offline codes differ from the streaming codes "
             f"where decided ({agree}/{decided})")
    for name, v in ctl.items():
        if v["equal"] == v["decided"]:
            fail(f"{label}: the control ({name}) passes the codes' check: "
                 f"it cannot tell that fault apart")
    return {"decided": decided, "equal": agree, "share": share,
            "controls": ctl}


@contextlib.contextmanager
def _scan_phases(pipe, split, keep):
    """Inside the block the scan's phases (``pipe.offline.encode``,
    ``pipe.lm_frames`` and ``pipe.offline.decode``, which STS runs) each
    run between two synchronizes, their host-clock ms appended to
    ``split[phase]``; ``keep["codes"]`` receives the encode's codes."""
    def timed(part, fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            sync()
            split.setdefault(part, []).append(
                (time.perf_counter() - t0) * 1e3)
            if part == "encode":
                keep["codes"] = res[0]
            return res
        return run

    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped(pipe.offline, "encode", timed(
            "encode", pipe.offline.encode)))
        stack.enter_context(swapped(pipe, "lm_frames", timed(
            "lm", pipe.lm_frames)))
        stack.enter_context(swapped(pipe.offline, "decode", timed(
            "decode", pipe.offline.decode)))
        yield


def _scan_turns(pipe, mparams, params, audio, seed, per_frame, label):
    """SCAN_TURNS scans of the clip from fresh states (sampling from
    ``seed``), each timed on the host clock (its phases apart, between
    synchronizes) with its outputs fetched; the launch counts zeroed just
    before each and asserted against ``per_frame`` per frame.  Every turn
    must give the first's outputs, bit for bit."""
    from moshi_tpu_torch.kernels import build
    n = audio.shape[0]
    turns = []
    for _ in range(SCAN_TURNS):
        state = pipe.init_state(1, seed=seed)
        split, keep = {}, {}
        with _scan_phases(pipe, split, keep):
            sync()
            build.COUNTS.clear()              # the scan's path starts here
            t0 = time.perf_counter()
            outs = pipe.scan_frames(mparams, params, state, audio)
            host = [o.cpu() for o in outs[:-1]]   # synchronizes
            ms = (time.perf_counter() - t0) * 1e3
            counts = dict(build.COUNTS)       # and ends here
        if counts != {k: v * n for k, v in per_frame.items()}:
            fail(f"{label}: launch counts over {n} frames: {counts}, "
                 f"expected {per_frame} per frame and no other kernel")
        turns.append({"ms": ms, "split": {k: sum(v) for k, v in
                                          split.items()},
                      "outs": outs[:-1], "host": host,
                      "codes": keep["codes"], "counts": counts})
    for t in turns[1:]:
        if not all(torch.equal(a, b) for a, b in zip(t["host"],
                                                     turns[0]["host"])):
            fail(f"{label}: a second scan of the same clip and seed gave "
                 f"other outputs")
    return turns


def run_scan(pipe, params, mparams, audio, seed, per_frame, label,
             step_ms=None):
    """An offline scan (``STSPipeline`` or ``STTPipeline.scan_frames``) of
    the clip ``audio`` [N, 1, fs] in SCAN_TURNS turns (``_scan_turns``),
    then the frame loop on the same work, timed on the host clock: per
    frame Mimi's streaming ``encode_step``, ``lm_gen_step`` of the scan's
    codes (a generator seeded as the scan's) and, for STS, the streaming
    ``decode_step`` of the scan's tokens.  Held: (a) the offline codes
    against the streaming codes (``hold_offline_codes``); (b) the scan's
    LM outputs (texts and tokens, or texts and the VAD) equal to the
    loop's, bit for bit; (c) for STS, the offline decode against the
    streaming decode of the same tokens within ``TOL["scan_audio"]``; (a)
    and (c) each against ``_MIMI_CONTROLS``.  ``step_ms``: phase 7's
    frame mean, logged beside.  Returns (what ``profile_scan`` takes, the
    report)."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime import pipeline
    sts = isinstance(pipe, pipeline.STSPipeline)
    mimi, bf, cfg = pipe.mimi, pipe.mimi_dtype, pipe.lm_cfg
    n, fs = audio.shape[0], pipe.frame_samples
    n_other = cfg.n_q - cfg.runtime_dep_q
    turns = _scan_turns(pipe, mparams, params, audio, seed, per_frame, label)
    host = turns[0]["host"]
    lead = host[1] if sts else host[0]
    shapes = [tuple(h.shape) for h in host]
    want = ([(n, 1), (n, 1, cfg.runtime_dep_q), (n, 1, fs)] if sts
            else [(n, 1), (n, 1)])
    if shapes != want or host[-1].dtype != torch.float32:
        fail(f"{label}: output shapes {shapes}, expected {want}")
    if not torch.isfinite(host[-1]).all():
        fail(f"{label}: non-finite outputs")
    if sts and (len(set(host[0].flatten().tolist())) < 2
                or (lead < 0).all()):
        fail(f"{label}: the outputs do not vary")
    if not sts and not (((host[1] >= 0) & (host[1] <= 1)).all()
                        and ((host[0] >= 0)
                             & (host[0] < cfg.text_card)).all()):
        fail(f"{label}: a text token or VAD out of range")
    codes = turns[0]["codes"]                            # [B, N, n_q]
    dec_codes = (pipeline._mimi_codes(turns[0]["outs"][1], mimi.cfg.n_q)
                 if sts else None)                       # [N, B, n_q]
    sampling = {"temp_text": pipe.temp_text, "top_k_text": pipe.top_k_text}
    if sts:
        sampling.update(temp=pipe.temp, top_k=pipe.top_k)
    es = mimi.init_encode_state(1, bf, DEV)
    ds = mimi.init_decode_state(1, bf, DEV)
    ls = lm.init_gen_state(cfg, 1, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q_in, stream, outs, wavs, loop_ms = [], [], [], [], []
    with recorded_quantizer(mimi, q_in):
        for f in range(n):
            t0 = time.perf_counter()
            c, es = mimi.encode_step(mparams, es, audio[f].to(bf))
            out, ls = lm.lm_gen_step(cfg, params, ls,
                                     other_audio=codes[:, f, :n_other],
                                     generator=gen, **sampling)
            if sts:
                w, ds = mimi.decode_step(mparams, ds, dec_codes[f][:, None])
                wavs.append(w.float())
                outs.append((out["text"], out["audio"]))
            else:
                outs.append((out["sampled_text"], out["vad"]))
            outs[-1][0].cpu()                  # synchronizes
            loop_ms.append((time.perf_counter() - t0) * 1e3)
            stream.append(c)
    stream, q_in = torch.cat(stream, dim=1), torch.cat(q_in, dim=1)
    same_lm = all(torch.equal(torch.stack([o[i] for o in outs]).cpu(),
                              host[i]) for i in range(2))
    ctl_codes, ctl_wav = {}, {}
    for name, ctx in _MIMI_CONTROLS:
        with ctx():
            ctl_codes[name] = pipe.offline.encode(
                mparams, mimi.init_encode_state(1, bf, DEV), audio)[0]
            if sts:
                ctl_wav[name] = pipe.offline.decode(
                    mparams, mimi.init_decode_state(1, bf, DEV),
                    dec_codes.transpose(0, 1))[0].cpu()
    scan_ms = [t["ms"] / n for t in turns]
    split = {k: v / n for k, v in turns[-1]["split"].items()}
    log(f"  {label}, B=1, {n} frames: host ms/frame in turns "
        + ", ".join(f"{m:.3f}" for m in scan_ms)
        + f"; phases per frame (the last turn) " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items())
        + f"; the frame loop on the same work {sum(loop_ms) / n:.3f} "
        f"ms/frame" + (f"; phase 7's frame {step_ms:.3f}" if step_ms
                       else "") + f"  [{CARD}]")
    held_codes = hold_offline_codes(label, mparams, q_in, stream, codes,
                                    ctl_codes)
    log(f"  {label}: the LM phase's outputs equal lm_gen_step frame by "
        f"frame on the scan's codes, bit for bit: {same_lm}")
    if not same_lm:
        fail(f"{label}: the LM phase's outputs differ from lm_gen_step "
             f"frame by frame")
    report = {"frames": n, "chunk": pipe.offline.chunk,
              "ms_per_frame_turns": scan_ms, "split_ms_per_frame": split,
              "loop_ms_per_frame": sum(loop_ms) / n, "loop_ms": loop_ms,
              "step_ms_per_frame": step_ms,
              "launches_per_frame": {k: v // n for k, v in
                                     turns[0]["counts"].items()},
              "codes": held_codes, "lm_bit_equal": same_lm}
    held = {"pipe": pipe, "audio": audio, "dec_codes": dec_codes,
            "codes": codes}
    if not sts:
        return held, report
    stream_wav = torch.stack(wavs).cpu()                 # [N, B, fs]
    err = rel_err(host[2], stream_wav)
    ctl = {k: rel_err(v, stream_wav) for k, v in ctl_wav.items()}
    log(f"  {label}: offline decode against the streaming decode of the "
        f"same tokens: rel err {err:.3e} (limit {TOL['scan_audio']:g}); "
        f"controls: " + "; ".join(f"{k} {v:.3e}" for k, v in ctl.items()))
    if err > TOL["scan_audio"]:
        fail(f"{label}: the offline decode differs from the streaming "
             f"decode by {err:.3e} > {TOL['scan_audio']:g}")
    for name, v in ctl.items():
        if v <= TOL["scan_audio"]:
            fail(f"{label}: the control ({name}) passes the audio limit: "
                 f"it cannot tell that fault apart")
    report.update(audio_rel_err=err, control_audio_rel_err=ctl,
                  tol_audio=TOL["scan_audio"])
    return held, report


def run_sts_scan(cfg, params, mimi, mparams, step_ms=None):
    """Phase 7 (sts_scan): ``STSPipeline.scan_frames`` on the 7B q4_k LM and
    the full Mimi over a clip of SCAN_FRAMES frames (its last Mimi chunk
    short) at the pipeline's sampling defaults, held by ``run_scan``."""
    from moshi_tpu_torch.runtime import pipeline
    pipe = pipeline.STSPipeline(mimi, cfg, device=DEV)
    audio = _scan_audio(pipe.frame_samples, SCAN_FRAMES, SEED + 60)
    return run_scan(pipe, params, mparams, audio, SEED + 61,
                    per_frame_launches(cfg),
                    f"STS scan (7B q4_k LM + Mimi n_q {mimi.cfg.n_q}, "
                    f"bf16, temp {pipe.temp}/{pipe.temp_text})", step_ms)


def run_stt_scan(cfg, params, mimi, mparams, step_ms=None):
    """Phase 7 (stt_scan): ``STTPipeline.scan_frames`` on the stt-1b LM and
    Mimi at n_q 32 over a clip of SCAN_FRAMES frames, text at temp 0.8
    (so that (b) holds the sampler's draws too), held by ``run_scan``."""
    from moshi_tpu_torch.runtime import pipeline
    pipe = pipeline.STTPipeline(mimi, cfg, temp_text=0.8, device=DEV)
    audio = _scan_audio(pipe.frame_samples, SCAN_FRAMES, SEED + 62)
    return run_scan(pipe, params, mparams, audio, SEED + 63,
                    stt_launches(cfg),
                    f"STT scan (stt-1b bf16 LM + Mimi n_q {mimi.cfg.n_q} "
                    f"encode, text temp {pipe.temp_text})", step_ms)[1]


def profile_scan(held, mparams, params):
    """Phase 7 (sts_scan): the STS scan's phases under the profiler: the
    offline Mimi encode and decode of the whole clip (SCAN_FRAMES frames,
    each one window) against the streaming ``encode_step`` +
    ``decode_step`` per frame, and the LM phase (``lm_frames``) over
    SCAN_PROFILE_FRAMES frames of the scan's codes; launches and device ms
    per frame, the scan's being its LM phase's and its offline Mimi's."""
    from moshi_tpu_torch.models import lm
    pipe, audio, dec_codes = held["pipe"], held["audio"], held["dec_codes"]
    mimi, bf, n, cfg = pipe.mimi, pipe.mimi_dtype, SCAN_FRAMES, pipe.lm_cfg
    dec_bt = dec_codes.transpose(0, 1)
    other = held["codes"][..., :cfg.n_q - cfg.runtime_dep_q].transpose(0, 1)

    def encode(f):
        pipe.offline.encode(mparams, mimi.init_encode_state(1, bf, DEV),
                            audio)[0].cpu()

    def decode(f):
        pipe.offline.decode(mparams, mimi.init_decode_state(1, bf, DEV),
                            dec_bt)[0].cpu()

    box = {"enc": mimi.init_encode_state(1, bf, DEV),
           "dec": mimi.init_decode_state(1, bf, DEV),
           "lm": lm.init_gen_state(cfg, 1, device=DEV),
           "gen": torch.Generator(device=DEV).manual_seed(SEED + 61)}

    def stream(f):
        c, box["enc"] = mimi.encode_step(mparams, box["enc"],
                                         audio[f].to(bf))
        w, box["dec"] = mimi.decode_step(mparams, box["dec"],
                                         dec_codes[f][:, None])
        w.cpu()

    def lm_phase(f):
        t, _, box["lm"] = pipe.lm_frames(params, box["lm"], other[f:f + 1],
                                         box["gen"])
        t.cpu()

    out = {"offline_encode": _profile(
               f"offline Mimi encode, {n} frames a window", encode, n=1),
           "offline_decode": _profile(
               f"offline Mimi decode, {n} frames a window", decode, n=1),
           "streaming": _profile("streaming Mimi encode_step + decode_step",
                                 stream),
           "lm_phase": _profile("the STS scan's LM phase", lm_phase,
                                n=SCAN_PROFILE_FRAMES)}
    per = {k: {"launches": out[k]["kernel_launches_per_frame"] / d,
               "device_ms": out[k]["device_busy_ms_per_frame"] / d}
           for k, d in (("offline_encode", n), ("offline_decode", n),
                        ("streaming", 1), ("lm_phase", 1))}
    off = {k: per["offline_encode"][k] + per["offline_decode"][k]
           for k in ("launches", "device_ms")}
    scan = {k: off[k] + per["lm_phase"][k] for k in off}
    log(f"  Mimi per frame, offline ({n}-frame clip, encode + decode): "
        f"{off['launches']:.2f} launches, {off['device_ms']:.3f} device ms; "
        f"streaming: {per['streaming']['launches']:.1f} launches, "
        f"{per['streaming']['device_ms']:.3f} device ms; the STS scan (its "
        f"LM phase and offline Mimi): {scan['launches']:.1f} launches, "
        f"{scan['device_ms']:.3f} device ms a frame  [{CARD}]")
    return dict(out, per_frame=per, offline_mimi_per_frame=off,
                scan_per_frame=scan)


@contextlib.contextmanager
def _scan_taped(pipe, tape, forced=None):
    """``_taped`` around a scan, which also writes to ``tape`` its Mimi
    codes and the quantizer's inputs; with ``forced`` the encode hands
    that run's codes to the LM, so that this run takes the other's inputs
    throughout."""
    encode = pipe.offline.encode
    tape["q_in"] = []

    def rec_encode(p, s, a):
        c, s = encode(p, s, a)
        tape["codes"] = c.cpu()
        return (c if forced is None else forced["codes"].to(c.device)), s

    with _taped(tape, forced), \
            recorded_quantizer(pipe.offline.model, tape["q_in"]), \
            swapped(pipe.offline, "encode", rec_encode):
        yield tape


def _tape_frames(tape, dep_q: int, vads=None):
    """A scan's tape as ``_compare``'s frames (at temp 0): per frame
    transformer_out, the text logits and their top token, the depformer's
    logits (None without one) and the VAD."""
    per = 1 + dep_q
    frames = []
    for f, h in enumerate(tape["h"]):
        lg = tape["logits"][f * per:(f + 1) * per]
        frames.append({"h": h, "logits": lg[0],
                       "dep_logits": torch.stack(lg[1:], 1) if dep_q else None,
                       "vad": None if vads is None else vads[f],
                       "text": lg[0].argmax(-1), "tokens": None})
    return frames


@reused_plain_weights()
def _scan_two_layers(label, pipe_of, params, mparams, audio, dep_q, tol,
                     tol_dep, tol_vad, control):
    """A scan at temp 0 on the card and on the CPU (same weights and audio;
    the CPU taking the card's codes and tokens), then the CPU again under
    ``control``: transformer_out, the logits and the VAD within their
    limits with the decided tokens equal (``_compare``), the decided Mimi
    codes equal, and the decoded audio (STS) within ``TOL["mimi_audio"]``;
    the control must fail the frames' check."""
    params_cpu = tree_to(params, "cpu")
    mparams_cpu = tree_to(mparams, "cpu")
    runs = {}
    for side, dev, p, mp in (("card", DEV, params, mparams),
                             ("cpu", "cpu", params_cpu, mparams_cpu),
                             ("control", "cpu", params_cpu, mparams_cpu)):
        pipe = pipe_of(dev)
        tape = {}
        ctx = control() if side == "control" else contextlib.nullcontext()
        with ctx, _scan_taped(pipe, tape, None if side == "card"
                              else runs["card"]["tape"]):
            outs = pipe.scan_frames(mp, p, pipe.init_state(1, seed=SEED + 70),
                                    audio.to(dev))
        runs[side] = {"tape": tape, "outs": [o.cpu() for o in outs[:-1]]}
    vads = {s: (r["outs"][1] if dep_q == 0 else None)
            for s, r in runs.items()}
    frames = {s: _tape_frames(r["tape"], dep_q, vads[s])
              for s, r in runs.items()}
    r = _compare(frames["card"], frames["cpu"], tol, tol_dep, tol_vad,
                 decided_only=True)
    c = _compare(frames["control"], frames["cpu"], tol, tol_dep, tol_vad,
                 decided_only=True)
    cpu_tape = runs["cpu"]["tape"]
    decided, agree = decided_codes(
        mparams_cpu, torch.cat(cpu_tape["q_in"], dim=1).float().cpu(),
        cpu_tape["codes"], runs["card"]["tape"]["codes"],
        cpu_tape["codes"].shape[-1])
    audio_err = (rel_err(runs["card"]["outs"][2], runs["cpu"]["outs"][2])
                 if dep_q else None)
    log(f"  {label}, {audio.shape[0]} frames at temp 0: {_show(r)}; Mimi "
        f"codes decided {decided}, equal {agree}"
        + (f"; decoded audio rel err {audio_err:.2e} (tol "
           f"{TOL['mimi_audio']:g})" if dep_q else "")
        + f"; control ({control.__name__}) against the CPU: {_show(c)}")
    if not r["passes"]:
        fail(f"{label}: card and CPU differ beyond {tol:g} (depformer "
             f"{tol_dep:g}) or in a decided token: {_show(r)}")
    if agree != decided or decided == 0:
        fail(f"{label}: card codes differ from the CPU's where decided "
             f"({agree}/{decided})")
    if dep_q and audio_err > TOL["mimi_audio"]:
        fail(f"{label}: decoded audio differs by {audio_err:.3e}")
    if c["passes"]:
        fail(f"{label}: the control ({control.__name__}) passes the check: "
             f"it cannot tell that rounding apart")
    return dict(r, codes_decided=decided, codes_equal=agree,
                audio_rel_err=audio_err, control=c,
                control_name=control.__name__, frames=audio.shape[0])


def dense_bf16_products():
    """The STT's control: every dense product rounded to bf16."""
    return dict(_stt_controls())["dense products rounded to bf16"]()


def compare_scan_two_layers(mimi, mparams, mimi32):
    """Phase 7 (sts_scan, stt_scan): 2 layers of the 7B geometry (q4_k) and
    of the stt-1b geometry (dense bf16) through ``scan_frames`` with the
    full Mimi, SCAN_FRAMES_2L frames, card against CPU as phase 4 holds
    the frame, with K1's control (7B) and the dense products' (stt-1b)."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime import pipeline
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = lm.LMConfig(delays=_7B_DELAYS, num_layers=2)
    params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 71)
    scfg = stt_config(2)
    sparams = synth_lm_params(scfg, None, device=DEV, seed=SEED + 72)
    fs = mimi.cfg.frame_samples
    audio = _scan_audio(fs, SCAN_FRAMES_2L, SEED + 73)
    with fusion("1"):
        sts = _scan_two_layers(
            "2-layer 7B STS scan", lambda d: pipeline.STSPipeline(
                mimi, cfg, temp=0.0, temp_text=0.0, device=d),
            params, mparams, audio, cfg.runtime_dep_q, TOL["frame_2l"],
            TOL["frame_2l_dep"], 0.0, k1_control)
    stt = _scan_two_layers(
        "2-layer stt-1b STT scan", lambda d: pipeline.STTPipeline(
            mimi32, scfg, device=d),
        sparams, mparams, audio, 0, TOL["stt_frame_2l"], 0.0,
        TOL["stt_vad"], dense_bf16_products)
    return {"sts": sts, "stt": stt}


def run_scan_mid_stream(cfg, params, mimi, mparams):
    """Phase 7 (sts_scan): SCAN_LEAD streaming ``STSPipeline.step`` frames,
    then ``scan_frames`` of SCAN_MID_FRAMES more (the streaming state's
    Mimi rings grown to the offline capacity), at the sampling defaults;
    its texts and tokens must equal the LM phase run alone from a fresh
    state with the same seed on the same Mimi codes (the steps' and the
    scan's), bit for bit."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime import pipeline
    pipe = pipeline.STSPipeline(mimi, cfg, device=DEV)
    n_other = cfg.n_q - cfg.runtime_dep_q
    audio = _scan_audio(pipe.frame_samples, SCAN_LEAD + SCAN_MID_FRAMES,
                        SEED + 64)
    state = pipe.init_state(1, seed=SEED + 65)
    step_codes, texts, toks = [], [], []
    encode = mimi.encode_step

    def rec(*a):
        c, s = encode(*a)
        step_codes.append(c)
        return c, s

    with swapped(mimi, "encode_step", rec):
        for f in range(SCAN_LEAD):
            out, state = pipe.step(mparams, params, state, audio[f])
            texts.append(out["text"])
            toks.append(out["audio_tokens"])
    caps = [state[k]["transformer"]["k"].shape[2] for k in ("enc", "dec")]
    split, keep = {}, {}
    with _scan_phases(pipe, split, keep):
        t, k, _, state = pipe.scan_frames(mparams, params, state,
                                          audio[SCAN_LEAD:])
    grown = [state[k]["transformer"]["k"].shape[2] for k in ("enc", "dec")]
    codes = torch.cat(step_codes + [keep["codes"]], dim=1)
    ref_t, ref_k, _ = pipe.lm_frames(
        params, lm.init_gen_state(cfg, 1, device=DEV),
        codes[..., :n_other].transpose(0, 1),
        torch.Generator(device=DEV).manual_seed(SEED + 65))
    same = (torch.equal(torch.cat([torch.stack(texts), t]).cpu(),
                        ref_t.cpu())
            and torch.equal(torch.cat([torch.stack(toks), k]).cpu(),
                            ref_k.cpu()))
    log(f"  mid-stream scan: {SCAN_LEAD} streaming frames (Mimi rings "
        f"{caps}), then a scan of {SCAN_MID_FRAMES} (rings grown to "
        f"{grown}); texts and tokens equal to the LM phase alone on the "
        f"same codes and seed, bit for bit: {same}")
    if not same or grown != [pipe.offline.cap] * 2:
        fail("mid-stream scan: the outputs differ from the LM phase alone, "
             "or the Mimi rings were not grown")
    return {"lead": SCAN_LEAD, "frames": SCAN_MID_FRAMES, "caps": caps,
            "grown": grown, "bit_equal": same}


def run_session(cfg, params):
    """Phase 7 (session): ``LMGenerator`` on the 7B q4_k LM at its
    sampling defaults, SESSION_FRAMES frames of ``send2`` / ``receive``,
    the launch counts zeroed just before and read just after; every
    frame's results equal, bit for bit, to ``lm_gen_step`` frame by frame
    from a fresh state with a generator of the same seed."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.session import LMGenerator
    n = SESSION_FRAMES
    gen = LMGenerator(cfg, params, seed=SEED + 66, device=DEV)
    cg = torch.Generator().manual_seed(SEED + 67)
    others = [torch.randint(0, cfg.card, (1, cfg.n_q - cfg.runtime_dep_q),
                            generator=cg) for _ in range(n)]
    outs, ms = [], []
    sync()
    build.COUNTS.clear()                      # the session path starts here
    for o in others:
        t0 = time.perf_counter()
        gen.send2(o.numpy())
        outs.append(gen.receive())            # fetched to the host
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = dict(build.COUNTS)               # and ends here
    per_frame = per_frame_launches(cfg)
    if counts != {k: v * n for k, v in per_frame.items()}:
        fail(f"LMGenerator: launch counts over {n} frames: {counts}, "
             f"expected {per_frame} per frame")
    state = lm.init_gen_state(cfg, 1, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED + 66)
    equal = 0
    for f, o in enumerate(others):
        out, state = lm.lm_gen_step(
            cfg, params, state, other_audio=o.to(DEV),
            depformer_replace=f < cfg.delay_steps, temp=gen.temp,
            temp_text=gen.temp_text, top_k=gen.top_k,
            top_k_text=gen.top_k_text, generator=g)
        ref = {"sampled_text": out["sampled_text"], "text": out["text"],
               "audio": out["audio"], "has_audio": out["valid"]}
        equal += all(np.array_equal(outs[f][k], v.cpu().numpy())
                     for k, v in ref.items())
    log(f"  LMGenerator (7B q4_k, send2 / receive), {n} frames at temp "
        f"{gen.temp}/{gen.temp_text}: {equal}/{n} frames equal to "
        f"lm_gen_step's, bit for bit; host ms/frame mean {sum(ms) / n:.3f} "
        f"[{CARD}]; launches per frame "
        f"{ {k: v // n for k, v in counts.items()} }")
    if equal != n:
        fail(f"LMGenerator: {n - equal} frames differ from lm_gen_step's")
    return {"frames": n, "frames_equal": equal, "ms_per_frame": ms,
            "launches_per_frame": {k: v // n for k, v in counts.items()}}


def tts_text_launches(cfg):
    """Kernel launches of a q4_k TTS frame whose depformer is replaced (the
    lead-in): the temporal stack's and the text head's."""
    t = cfg.num_layers
    return {"int8_matvec": 6 * t + 1, "decode_attention4": t,
            "ring_write4": t}


def run_tts_session(cfg, params, mimi, mparams):
    """Phase 7 (session): a TTS ``LMGenerator`` with the text StateMachine
    on the cross-attention TTS class (q4_k, a synthetic voice: its
    condition_sum and cross K/V), TTS_SESSION_FRAMES frames from a script
    (the first ``delay_steps`` with the depformer replaced),
    against ``TTSPipeline.step`` with the host FSM, the same machine
    parameters, script, seed, sampling and depformer lead-in: every text
    and audio token and validity equal, bit for bit, and the launches
    per frame the TTS frame's."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models.state_machine import StateMachine
    from moshi_tpu_torch.nn.transformer import transformer_cross_kv
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    from moshi_tpu_torch.runtime.session import LMGenerator
    n = TTS_SESSION_FRAMES
    csum, cross = tts_voice(cfg, SEED + 68)
    ckv = transformer_cross_kv(cfg.transformer, params["transformer"], cross)
    pipe = TTSPipeline(mimi, cfg, device=DEV)
    script = tts_scripts(cfg, 3)[2]
    machine = StateMachine(text_card=cfg.text_card + 1)
    gen = LMGenerator(cfg, params, temp=pipe.temp, temp_text=pipe.temp_text,
                      top_k=pipe.top_k, top_k_text=pipe.top_k_text,
                      machine=machine, condition_sum=csum, cross_kv=ckv,
                      seed=SEED + 69, device=DEV)
    for entry in script:
        gen.send(entry)
    outs = []
    sync()
    build.COUNTS.clear()                      # the TTS session starts here
    for _ in range(n):
        outs.append(gen.receive())
    counts = dict(build.COUNTS)               # and ends here
    lead = min(n, cfg.delay_steps)            # frames without a depformer
    full, text = tts_launches(cfg), tts_text_launches(cfg)
    want = {k: (n - lead) * v + lead * text.get(k, 0)
            for k, v in full.items()}
    if counts != {k: v for k, v in want.items() if v}:
        fail(f"TTS LMGenerator: launch counts over {n} frames: {counts}, "
             f"expected {full} per frame, {text} in the {lead} frames of "
             f"the depformer's lead-in")
    ms = machine.new_state(list(script))
    state = pipe.init_state(1, seed=SEED + 69)
    equal = 0
    for f in range(n):
        out, state = pipe.step(mparams, params, state, machine=machine,
                               machine_state=ms, offset=f,
                               condition_sum=csum, cross_kv=ckv,
                               depformer_replace=f < cfg.delay_steps)
        ref = {"sampled_text": out["sampled_text"], "text": out["text"],
               "audio": out["audio_tokens"], "has_audio": out["valid"]}
        equal += all(np.array_equal(outs[f][k], v.cpu().numpy())
                     for k, v in ref.items())
    log(f"  TTS LMGenerator (TTS class q4_k, a voice, the host FSM), {n} "
        f"frames at temp {gen.temp}/{gen.temp_text}: {equal}/{n} frames "
        f"equal to TTSPipeline.step's, bit for bit; launches {counts} "
        f"({lead} lead-in frames without the depformer)")
    if equal != n:
        fail(f"TTS LMGenerator: {n - equal} frames differ from "
             f"TTSPipeline.step's")
    return {"frames": n, "frames_equal": equal, "lead_in": lead,
            "launches": counts}


def check_mimi_streamer(mimi, mparams, dep_q: int):
    """Phase 7 (session): ``MimiStreamer`` (bf16) at full width against
    ``encode_step`` / ``decode_step`` on fresh states: STREAMER_FRAMES
    frames, each frame's codes equal, and the decode of them, of a
    [B, n_q] frame with -1 codes and of ``dep_q`` books (padded) equal,
    bit for bit."""
    from moshi_tpu_torch.runtime.session import MimiStreamer
    bf = torch.bfloat16
    st = MimiStreamer(mimi, mparams, dtype=bf, device=DEV)
    es = mimi.init_encode_state(1, bf, DEV)
    ds = mimi.init_decode_state(1, bf, DEV)
    audio = _scan_audio(mimi.cfg.frame_samples, STREAMER_FRAMES, SEED + 74)
    equal = 0
    for f in range(STREAMER_FRAMES):
        codes = st.encode(audio[f].cpu().numpy())
        ref, es = mimi.encode_step(mparams, es, audio[f].to(bf))
        frame = codes[:, 0]
        if f == 1:
            frame = np.where(np.arange(frame.shape[1]) % 3 == 0, -1, frame)
        if f == 2:
            frame = frame[:, :dep_q]
        wav = st.decode(frame)
        full = np.zeros((1, mimi.cfg.n_q), np.int64)
        full[:, :frame.shape[1]] = np.maximum(frame, 0)
        ref_w, ds = mimi.decode_step(mparams, ds,
                                     torch.from_numpy(full)[:, None].to(DEV))
        equal += (np.array_equal(codes, ref.cpu().numpy())
                  and np.array_equal(wav, ref_w.float().cpu().numpy()))
    log(f"  MimiStreamer (bf16, n_q {mimi.cfg.n_q}): {equal}/"
        f"{STREAMER_FRAMES} frames' codes and audio equal to encode_step / "
        f"decode_step's (a frame with -1 codes, one of {dep_q} books)")
    if equal != STREAMER_FRAMES:
        fail("MimiStreamer: codes or audio differ from encode_step / "
             "decode_step")
    return {"frames": STREAMER_FRAMES, "frames_equal": equal}


# ---------------------------------------------------------------------------
# phase 8 (load, tts_demux): weights from files, and the TTS class with the
# demuxed text stream and depformer RoPE
# ---------------------------------------------------------------------------

_NORMS = ("norm1", "norm2", "norm_cross", "out_norm")


def as_loaded(tree):
    """An LM tree as ``load_lm_params`` returns it from its own GGUF file:
    norms in f32 (their bf16 values widened, exact), every other leaf as
    it is."""
    return {k: ({n: t.float() for n, t in v.items()} if k in _NORMS
                else as_loaded(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


def mimi_as_loaded(tree, path=()):
    """A Mimi tree as ``load_mimi_params`` returns it from its own GGUF
    file: conv and projection weights through f16 (``save_mimi_gguf``
    stores them so: values f16 does not hold round), norms, biases, layer
    scales and codebooks in f32, attention and FFN weights as they are."""
    if isinstance(tree, dict):
        return {k: mimi_as_loaded(v, path + (k,)) for k, v in tree.items()}
    top, leaf = path[0], path[-1]
    if leaf in ("bias", "scale", "embeddings") or path[-2] in (
            "norm1", "norm2"):
        return tree.float()
    if top in ("encoder", "decoder", "downsample", "upsample") or \
            path[-2] in ("input_proj", "output_proj"):
        return tree.float().half().to(tree.dtype)
    return tree


def _tree_diff(got, ref, path=""):
    """Leaves compared on the device (``torch.equal``, dtypes too):
    (leaves, [paths that differ])."""
    from moshi_tpu_torch.quant.formats import QuantTensor
    if isinstance(ref, dict):
        if not isinstance(got, dict) or set(got) != set(ref):
            return 1, [path or "/"]
        n, bad = 0, []
        for k in ref:
            a, b = _tree_diff(got[k], ref[k], f"{path}/{k}")
            n, bad = n + a, bad + b
        return n, bad
    if isinstance(ref, QuantTensor):
        same = (isinstance(got, QuantTensor) and got.fmt == ref.fmt
                and tuple(got.shape) == tuple(ref.shape))
        if not same:
            return 1, [path]
        n, bad = 0, []
        for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
            a, b = getattr(got, f), getattr(ref, f)
            if (a is None) != (b is None):
                bad.append(f"{path}#{f}")
            elif b is not None:
                n += 1
                if a.dtype != b.dtype or not torch.equal(a, b):
                    bad.append(f"{path}#{f}")
        return n, bad
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        return 1, [path]
    return 1, []


def scales_f16_exact(tree):
    """(scales, scales f16 does not hold) over every QuantTensor's d and
    dmin: the file keeps them as f16."""
    from moshi_tpu_torch.quant.formats import QuantTensor
    if isinstance(tree, dict):
        n = bad = 0
        for v in tree.values():
            a, b = scales_f16_exact(v)
            n, bad = n + a, bad + b
        return n, bad
    if not isinstance(tree, QuantTensor):
        return 0, 0
    n = bad = 0
    for s in (tree.d, tree.dmin):
        if s is not None:
            f = s.float()
            n += s.numel()
            bad += int((f.half().float() != f).sum())
    return n, bad


def _lm_frames(cfg, params, n, seed):
    """``n`` LM frames at the sampling defaults from a fresh B = 1 state,
    inputs and sampling from a generator seeded ``seed``: the tape (every
    sample_token's logits and token) and the launches counted over them."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models import lm
    gen = torch.Generator(device=DEV).manual_seed(seed)
    other = torch.randint(0, cfg.card, (n, 1, cfg.n_q - cfg.dep_q),
                          generator=gen, device=DEV)
    state = lm.init_gen_state(cfg, 1, device=DEV)
    tape = {}
    build.COUNTS.clear()                  # the load path starts here
    with _taped(tape):
        for f in range(n):
            _, state = lm.lm_gen_step(cfg, params, state,
                                      other_audio=other[f], generator=gen)
    sync()
    counts = dict(build.COUNTS)           # the load path ends here
    return tape, counts


def _tapes_equal(a, b) -> bool:
    return (len(a["logits"]) == len(b["logits"])
            and all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                      b["logits"]))
            and all(torch.equal(x, y) for x, y in zip(a["tokens"],
                                                      b["tokens"])))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def load_lm_roundtrip(cfg, params, tmp):
    """The 7B q4_k tree through ``save_lm_gguf`` and ``load_lm_params`` on
    the card: every leaf equal to the in-memory one (norms come back f32,
    equal in value), then LOAD_FRAMES LM frames from each tree on the same
    seed, their logits and tokens bit for bit equal, the loaded tree's
    launches those of the 7B frame."""
    from moshi_tpu_torch.runtime.loader import load_lm_params, save_lm_gguf
    n_sc, bad_sc = scales_f16_exact(params)
    log(f"  the 7B tree's quantization scales f16 holds exactly: "
        f"{n_sc - bad_sc} of {n_sc}")
    if bad_sc:
        fail(f"7B GGUF: {bad_sc} of the tree's {n_sc} bf16 scales are not "
             f"f16 values, so its GGUF cannot hold them exactly")
    path = os.path.join(tmp, "lm-7b-q4_k.gguf")
    _, write_s = _timed(lambda: save_lm_gguf(path, params, cfg))
    size = os.path.getsize(path)
    loaded, read_s = _timed(lambda: load_lm_params(path, cfg, device=DEV))
    os.remove(path)
    leaves, bad = _tree_diff(loaded, as_loaded(params))
    log(f"  7B q4_k GGUF: {size} bytes ({size / 2 ** 30:.3f} GiB), written "
        f"in {write_s:.2f} s, read to the card in {read_s:.2f} s; {leaves} "
        f"tensors compared, {len(bad)} differ  [{CARD}]")
    if bad:
        fail(f"7B GGUF round trip: {len(bad)} tensors differ from the "
             f"in-memory tree: {bad[:8]}")
    ref, counts_ref = _lm_frames(cfg, params, LOAD_FRAMES, SEED + 60)
    got, counts = _lm_frames(cfg, loaded, LOAD_FRAMES, SEED + 60)
    del loaded
    per_frame = per_frame_launches(cfg)
    equal = _tapes_equal(got, ref)
    log(f"  {LOAD_FRAMES} LM frames from the loaded tree against the "
        f"in-memory tree, same seed: logits and tokens bit for bit equal: "
        f"{equal}; launches per frame "
        f"{ {k: v // LOAD_FRAMES for k, v in counts.items()} }")
    if not equal:
        fail("7B GGUF: the loaded tree's frames differ from the in-memory "
             "tree's")
    expect = {k: v * LOAD_FRAMES for k, v in per_frame.items()}
    if counts != expect or counts_ref != expect:
        fail(f"7B GGUF: launches over {LOAD_FRAMES} frames {counts} "
             f"(in-memory {counts_ref}), expected {per_frame} per frame")
    return {"gguf_bytes": size, "write_s": write_s, "read_s": read_s,
            "tensors": leaves, "scales": n_sc, "frames": LOAD_FRAMES,
            "frames_equal": equal,
            "launches_per_frame": {k: v // LOAD_FRAMES
                                   for k, v in counts.items()}}


def load_mimi_roundtrip(mimi, mparams, tmp):
    """The full-width Mimi through ``save_mimi_gguf`` and
    ``load_mimi_params`` on the card: every leaf equal to the in-memory
    tree as the file stores it (``mimi_as_loaded``), and one encode and
    decode frame of the loaded tree bit for bit that tree's."""
    from moshi_tpu_torch.runtime.loader import load_mimi_params, \
        save_mimi_gguf
    path = os.path.join(tmp, "mimi.gguf")
    _, write_s = _timed(lambda: save_mimi_gguf(path, mparams, mimi))
    size = os.path.getsize(path)
    loaded, read_s = _timed(lambda: load_mimi_params(path, mimi, device=DEV))
    os.remove(path)
    expect = mimi_as_loaded(mparams)
    leaves, bad = _tree_diff(loaded, expect)
    rounded = sum(int((expect[k][m]["weight"] != mparams[k][m]["weight"])
                      .sum()) for k in ("encoder", "decoder")
                  for m in mparams[k])
    log(f"  Mimi GGUF: {size} bytes, written in {write_s:.2f} s, read in "
        f"{read_s:.2f} s; {leaves} tensors compared, {len(bad)} differ; "
        f"SEANet conv values f16 rounds: {rounded}  [{CARD}]")
    if bad:
        fail(f"Mimi GGUF round trip: {len(bad)} tensors differ: {bad[:8]}")
    fs = mimi.cfg.frame_samples
    audio = torch.randn((1, fs), generator=torch.Generator(device=DEV)
                        .manual_seed(SEED + 61), device=DEV) * 0.1
    outs = []
    for tree in (loaded, expect):
        enc = mimi.init_encode_state(1, torch.bfloat16, DEV)
        dec = mimi.init_decode_state(1, torch.bfloat16, DEV)
        codes, _ = mimi.encode_step(tree, enc, audio)
        wav, _ = mimi.decode_step(tree, dec, codes)
        outs.append((codes, wav))
    equal = (torch.equal(outs[0][0], outs[1][0])
             and torch.equal(outs[0][1], outs[1][1]))
    finite = bool(torch.isfinite(outs[0][1]).all())
    log(f"  Mimi frame from the loaded tree: codes and audio bit for bit "
        f"the file's tree's: {equal}; audio finite: {finite}")
    if not (equal and finite):
        fail("Mimi GGUF: the loaded tree's frame differs or is not finite")
    return {"gguf_bytes": size, "write_s": write_s, "read_s": read_s,
            "tensors": leaves, "conv_values_rounded": rounded,
            "frame_equal": equal}


def _q_values(q, fmt):
    """The integer values [O, I] of a q8_0 or (planar) q4_0 weight."""
    if fmt == "q8_0":
        return q.astype(np.int32)
    return np.concatenate([q & 15, q >> 4], -1).astype(np.int32)


def _tie_rule(w, fmt, nat):
    """A chunk of rows of ``w`` through the numpy quantizer against the
    native one's values ``nat``: (elements, exact ties, values that
    differ, values that differ off a tie, values off the native rule
    (round half away from zero), scales that differ)."""
    from moshi_tpu_torch.quant import formats as F
    ref = (F._quantize_q8_0 if fmt == "q8_0" else F._quantize_q4_0)(w)
    o, i = w.shape
    d = ref["d"]
    if fmt == "q8_0":
        inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-30), 0.0)
    else:
        inv = np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    x = (w.reshape(o, i // 32, 32) * inv.astype(np.float32)[..., None]
         ).reshape(o, i)
    tie = np.abs(x - np.trunc(x)) == 0.5          # exact in f32
    qn, qr = _q_values(nat["q"], fmt), _q_values(ref["q"], fmt)
    differ = qn != qr
    # at a tie the native rule rounds away from zero
    xt = x[tie]
    away = np.trunc(xt) + np.sign(xt)
    away = (np.clip(away, -127, 127) if fmt == "q8_0"
            else np.clip(away + 8, 0, 15))
    off_tie = int((differ & ~tie).sum())
    d_bits = np.asarray(d, np.float32).view(np.uint32) >> 16
    return np.array([w.size, int(tie.sum()), int(differ.sum()), off_tie,
                     off_tie + int((qn[tie] != away).sum()),
                     int((d_bits != nat["d"]).sum())])


def check_quantize_on_load(cfg, tmp, gen):
    """Quantize on load at full width: a bf16 safetensors checkpoint of a
    7B-width LM of QLOAD_LAYERS temporal layers (no depformer) under the
    checkpoint's names, loaded on the card with ``fmt="q4_k"``, which
    builds the native quantizer on this host.  On the layers' weights:
    the native q8_0 and q4_0 values equal numpy's but at exact ties, where
    they round half away from zero (numpy half to even), and their scales
    equal; the loaded q4_k dequantizes within the JAX package's bound
    against numpy's (mean |difference| / mean |w| < 0.02)."""
    from concurrent.futures import ThreadPoolExecutor
    from moshi_tpu_torch import native_quant
    from moshi_tpu_torch.io.safetensors import save_safetensors
    from moshi_tpu_torch.quant import formats as F
    from moshi_tpu_torch.runtime.loader import load_lm_params
    qcfg = dataclasses.replace(cfg, num_layers=QLOAD_LAYERS, dep_q=0)
    d, hid = qcfg.dim, qcfg.hidden_dim
    shapes = {"lm.text_emb.weight": (qcfg.text_card + 1, d),
              "lm.out_norm.alpha": (1, 1, d),
              "lm.text_linear.weight": (qcfg.text_card, d)}
    for i in range(qcfg.n_q):
        shapes[f"lm.emb.{i}.weight"] = (qcfg.card + 1, d)
    layer_w = []
    for i in range(QLOAD_LAYERS):
        lp = f"lm.transformer.layers.{i}"
        shapes[f"{lp}.norm1.alpha"] = (1, 1, d)
        shapes[f"{lp}.norm2.alpha"] = (1, 1, d)
        for name, shape, key in (
                ("self_attn.in_proj_weight", (3 * d, d), ("self_attn",
                                                          "in_proj")),
                ("self_attn.out_proj.weight", (d, d), ("self_attn",
                                                       "out_proj")),
                ("gating.linear_in.weight", (2 * hid, d), ("gating",
                                                           "linear_in")),
                ("gating.linear_out.weight", (d, hid), ("gating",
                                                        "linear_out"))):
            shapes[f"{lp}.{name}"] = shape
            layer_w.append((f"{lp}.{name}", i, key))
    host = {}
    for name, shape in shapes.items():
        t = (torch.randn(shape, generator=gen, device=DEV) * 0.02).to(
            torch.bfloat16)
        host[name] = (t.view(torch.int16).cpu().numpy().view(np.uint16),
                      "BF16")
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    path = os.path.join(tmp, "lm-2-layers-bf16.safetensors")
    _, write_s = _timed(lambda: save_safetensors(path, host))
    size = os.path.getsize(path)
    built = not native_quant.lib_path().exists()
    _, build_s = _timed(native_quant.build)
    quant_s = [0.0]
    quantize_native = native_quant.quantize_native

    def timed_native(w, fmt):
        t0 = time.perf_counter()
        out = quantize_native(w, fmt)
        quant_s[0] += time.perf_counter() - t0
        return out

    native_quant.quantize_native = timed_native
    try:
        loaded, load_s = _timed(lambda: load_lm_params(
            path, qcfg, fmt="q4_k", device=DEV))
    finally:
        native_quant.quantize_native = quantize_native
    os.remove(path)
    log(f"  quantize on load: {n_params} bf16 weights in a {size}-byte "
        f"safetensors file ({QLOAD_LAYERS} 7B-width layers, the text and "
        f"audio embeddings, the text head) written in {write_s:.2f} s; the "
        f"native quantizer {'built' if built else 'found built'} in "
        f"{build_s:.2f} s; load_lm_params(fmt='q4_k') on the card "
        f"{load_s:.2f} s, of which the native q4_k quantization "
        f"{quant_s[0]:.2f} s  [{CARD}]")
    lay = loaded["transformer"]["layers"]
    fmts = {name: lay[k[0]][k[1]]["weight"].fmt for name, _, k in layer_w}
    fmts.update({n: loaded[n]["weight"].fmt
                 for n in ("text_emb", "text_linear")})
    fmts["emb"] = loaded["emb"]["weight"].fmt
    if set(fmts.values()) != {"q4_k"}:
        fail(f"quantize on load: formats {fmts}, expected q4_k throughout")
    # the numpy references, on row chunks in threads (the quantizers work
    # row by row)
    tie = np.zeros(6, np.int64)
    worst_k = 0.0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
        for name, layer, key in layer_w:
            raw = host[name][0]
            w = (raw.astype(np.uint32) << 16).view(np.float32).reshape(
                shapes[name])
            chunks = np.array_split(np.arange(w.shape[0]),
                                    2 * (os.cpu_count() or 8))
            for fmt in ("q8_0", "q4_0"):
                nat = quantize_native(w, fmt)
                futs = [pool.submit(_tie_rule, w[c], fmt,
                                    {"q": nat["q"][c], "d": nat["d"][c]})
                        for c in chunks]
                tie += sum(f.result() for f in futs)
            ref = [pool.submit(F._quantize_q4_k, w[c]) for c in chunks]
            ref = [f.result() for f in ref]
            qt = F.QuantTensor("q4_k", w.shape, **{
                k: (torch.from_numpy(np.concatenate([r[k] for r in ref]))
                    .to(DEV)) for k in ("q", "sc", "mn")},
                **{k: torch.from_numpy(np.concatenate(
                    [r[k] for r in ref])).to(DEV).to(torch.bfloat16)
                   for k in ("d", "dmin")})
            got = lay[key[0]][key[1]]["weight"]._map(lambda a: a[layer])
            a = F.dequantize(got, torch.float32)
            b = F.dequantize(qt, torch.float32)
            wd = torch.from_numpy(w).to(DEV)
            worst_k = max(worst_k, float((a - b).abs().mean()
                                         / wd.abs().mean()))
    ref_s = time.perf_counter() - t0
    del loaded
    n, ties, differ, off_tie, off_rule, d_differ = (int(v) for v in tie)
    log(f"  native against numpy on the layers' weights (q8_0 and q4_0, "
        f"{n} values): {ties} exact ties, {differ} values differ, "
        f"{off_tie} of them off a tie, {off_rule} off the native rule "
        f"(round half away), {d_differ} scales differ; q4_k mean "
        f"|native - numpy| / mean |w| {worst_k:.2e} (bound 0.02); numpy "
        f"references {ref_s:.2f} s on {os.cpu_count()} threads")
    if off_tie or off_rule or d_differ:
        fail(f"quantize on load: the native quantizer differs from numpy "
             f"off the ties ({off_tie} values, {off_rule} off its rule, "
             f"{d_differ} scales)")
    if not worst_k < 0.02:
        fail(f"quantize on load: q4_k differs from numpy by {worst_k:.3e} "
             f"of mean |w| (bound 0.02)")
    return {"params": n_params, "safetensors_bytes": size,
            "write_s": write_s, "native_built": built, "build_s": build_s,
            "load_s": load_s, "native_quant_s": quant_s[0],
            "values": n, "ties": ties, "values_differ": differ,
            "q4_k_mean_rel": worst_k, "numpy_ref_s": ref_s}


def run_load(cfg, params, mimi, mparams):
    """Phase 8 (load): every file written into a temporary directory that
    is removed after, its free space logged first."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_load_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"  free disk space where the files go: {free} bytes "
            f"({free / 2 ** 30:.1f} GiB)")
        out = {"free_disk_bytes": free}
        out.update(load_lm_roundtrip(cfg, params, tmp))
        out["mimi"] = load_mimi_roundtrip(mimi, mparams, tmp)
        out["quantize_on_load"] = check_quantize_on_load(
            cfg, tmp, torch.Generator(device=DEV).manual_seed(SEED + 62))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def tts_second_ahead() -> int:
    """The TTS class's second_stream_ahead (its tts_config)."""
    from moshi_tpu_torch.runtime.synth import tts_class_config
    return tts_class_config()[0].tts_config.second_stream_ahead


def tts_demux_config(num_layers: int = 0):
    """The TTS class (``tts_config``) with the demuxed text stream and
    depformer RoPE on."""
    return dataclasses.replace(tts_config(num_layers),
                               demux_second_stream=True,
                               depformer_pos_emb="rope")


def sharpen_depformer(params, qk: float = 8.0, alpha: float = 32.0):
    """The depformer's norm1 alpha times ``alpha`` and the q and k rows of
    its in_proj times ``qk``, in place; powers of two, so every bf16 value
    and scale stays exact.  The synthetic weights (alphas ~0.02) give
    scores q.k ~ 1e-5 and an attention output ~1e-3 of the residual: the
    rope, any rope, would not move the logits."""
    from moshi_tpu_torch.quant.formats import QuantTensor
    lay = params["depformer"]["layers"]
    lay["norm1"]["alpha"].mul_(alpha)
    w = lay["self_attn"]["in_proj"]["weight"]
    rows = 2 * lay["norm1"]["alpha"].shape[-1]
    if isinstance(w, QuantTensor):
        for t in (w.d, w.dmin, w.es, w.em):
            t[..., :rows, :].mul_(qk)
    else:
        w[..., :rows, :].mul_(qk)
    return params


@contextlib.contextmanager
def rope_at_frame_offset():
    """The depformer's rope taken at the frame's offset for every step, in
    place of the step index."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime import pipeline
    cur = {}
    audio_step, angles = lm.lm_audio_step, lm.rope_angles

    def spy(cfg, params, state, *a, **kw):
        cur["offset"] = state["offset"]
        return audio_step(cfg, params, state, *a, **kw)

    def at_offset(pos, *a, **kw):
        return angles(cur["offset"].reshape(pos.shape).to(pos.dtype), *a,
                      **kw)

    with swapped(lm, "lm_audio_step", spy), \
            swapped(pipeline, "lm_audio_step", spy), \
            swapped(lm, "rope_angles", at_offset):
        yield


@contextlib.contextmanager
def second_stream_dropped():
    """The demuxed embedding without its second stream's term (out2)."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.nn.layers import linear, scaled_embedding

    def first_only(params, ids, card, out_dtype=torch.float32):
        first = torch.where(ids >= 0, torch.remainder(ids, card),
                            torch.full_like(ids, -1))
        return linear(params["out1"], scaled_embedding(
            params, first, out_dtype)).to(out_dtype)

    with swapped(lm, "demux_embedding", first_only):
        yield


def _tts_demux_frames(cfg, params, mimi, mparams, voice, device, n,
                      forced=None):
    """``n`` ``TTSPipeline.step_device`` frames at temp 0 from a fresh
    B = 1 state on ``device``, the device FSM muxing its second stream two
    words ahead; the tape of every sample_token call, and the machine's
    text tokens."""
    from moshi_tpu_torch.models.device_machine import (compile_script,
                                                       init_device_state)
    from moshi_tpu_torch.models.state_machine import StateMachine
    from moshi_tpu_torch.nn.transformer import transformer_cross_kv
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    pipe = TTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0, device=device)
    # no initial padding: the second stream starts at the first frame
    dm = pipe.enable_device_fsm(StateMachine(
        text_card=cfg.text_card + 1, second_stream_ahead=tts_second_ahead(),
        initial_padding=0))
    script = compile_script(tts_scripts(cfg, 4)[3:], dm, device=device)
    csum, cross = (v.to(device) for v in voice)
    ckv = transformer_cross_kv(cfg.transformer, params["transformer"], cross)
    state = pipe.init_state(1, seed=SEED + 63)
    mstate = init_device_state(dm, script)
    tape, texts = {}, []
    with _taped(tape, forced):
        for _ in range(n):
            out, state, mstate = pipe.step_device(
                mparams, params, state, mstate, script, condition_sum=csum,
                cross_kv=ckv)
            texts.append(int(out["machine_text"][0]))
    return tape, texts


@reused_plain_weights()
def compare_tts_demux_two_layers(mimi, mparams):
    """Phase 8 (tts_demux): 2 layers of the TTS class with the demuxed
    stream and depformer RoPE at B = 1, card against CPU over
    TTS_DEMUX_FRAMES_2L ``step_device`` frames (the CPU following the
    card's tokens), its depformer sharpened (``sharpen_depformer``) so
    that the rope decides; controls: the rope at the frame's offset, and
    the second stream dropped."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = tts_demux_config(2)
    tol, tol_dep = TOL["tts_demux_2l"], TOL["tts_demux_2l_dep"]
    params = sharpen_depformer(synth_lm_params(cfg, "q4_k", device=DEV,
                                               seed=SEED + 64))
    step_w = lm._per_step_weights(cfg, params["depformer"])
    form = "stacked" if lm._can_use_dep_stacked(cfg, step_w, 1) \
        else "generic"
    params_cpu = tree_to(params, "cpu")
    mparams_cpu = tree_to(mparams, "cpu")
    voice = tts_voice(cfg, SEED + 65)
    n = TTS_DEMUX_FRAMES_2L
    t0 = time.perf_counter()
    card, texts = _tts_demux_frames(cfg, params, mimi, mparams, voice, DEV, n)
    cpu, cpu_texts = _tts_demux_frames(cfg, params_cpu, mimi, mparams_cpu,
                                       voice, "cpu", n, forced=card)
    r = _tts_compare(card, cpu, tol, tol_dep, cfg.card)
    # a muxed token reaches the temporal embedding on the next frame
    muxed = sum(t >= cfg.text_card + 1 for t in texts[:-1])
    log(f"  TTS demux+rope 2 layers, {n} frames, depformer {form}: "
        f"{_show(r)}; machine text {texts} ({muxed} carry the second "
        f"stream)  [{time.perf_counter() - t0:.1f} s]")
    controls = {}
    for name, ctx in (("rope at the frame offset", rope_at_frame_offset),
                      ("second stream dropped", second_stream_dropped)):
        with ctx():
            ctl, _ = _tts_demux_frames(cfg, params_cpu, mimi, mparams_cpu,
                                       voice, "cpu", n, forced=card)
        controls[name] = _tts_compare(ctl, cpu, tol, tol_dep, cfg.card)
        log(f"  TTS demux+rope 2 layers, control ({name}) against the "
            f"CPU: {_show(controls[name])}")
    del params, params_cpu, mparams_cpu
    if texts != cpu_texts or not muxed:
        fail(f"TTS demux: the machine's text differs between card and CPU "
             f"({texts} / {cpu_texts}) or carries no second stream before "
             f"the last frame")
    if not r["passes"]:
        fail(f"TTS demux 2-layer frame: card and CPU differ beyond {tol:g} "
             f"(depformer {tol_dep:g}) or in a decided token: {_show(r)}")
    for name, c in controls.items():
        if c["passes"]:
            fail(f"TTS demux 2-layer frame: the control ({name}) passes "
                 f"the check: it cannot tell that change apart")
    return dict(r, frames=n, depformer_form=form, machine_text=texts,
                controls=controls, tol_rel=tol, tol_dep_rel=tol_dep)


def tts_demux_launches(cfg):
    """The TTS frame's launches (``tts_launches``) with the demuxed
    stream: K1 also takes ``out1`` and ``out2`` of the temporal and of the
    depformer's text embedding."""
    counts = tts_launches(cfg)
    counts["int8_matvec"] += 4
    return counts


def run_tts_demux(mimi, mparams):
    """Phase 8 (tts_demux): the full-depth TTS class with both options on,
    B = 1, ``TTSPipeline.step_device`` with a voice and the device FSM
    muxing its second stream; its launches asserted."""
    from moshi_tpu_torch.models import lm
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = tts_demux_config()
    params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED + 66)
    step_w = lm._per_step_weights(cfg, params["depformer"])
    form = "stacked" if lm._can_use_dep_stacked(cfg, step_w, 1) \
        else "generic"
    log(f"  TTS class with demux and depformer rope: the depformer takes "
        f"its {form} form")
    out = run_tts(cfg, params, mimi, mparams,
                  tts_floor_ms(cfg, params, TTS_DEMUX_WARMUP
                               + (TTS_DEMUX_FRAMES + 1) / 2),
                  warmup=TTS_DEMUX_WARMUP, frames=TTS_DEMUX_FRAMES,
                  per_frame=tts_demux_launches(cfg),
                  second_ahead=tts_second_ahead(), label="demux+rope")
    out["depformer_form"] = form
    return out


_SOURCES = {
    "int8_matvec": ("moshi_tpu_torch/csrc/int8_matvec.cu",
                    "moshi_tpu/quant/pallas_matmul_int8.py:829", "sts"),
    "dequant_matvec": ("moshi_tpu_torch/csrc/dequant_matvec.cu",
                       "moshi_tpu/quant/pallas_matmul.py:667", "sts"),
    "decode_attention": ("moshi_tpu_torch/csrc/decode_attention.cu",
                         "moshi_tpu/nn/pallas_attention.py:393", "sts"),
    "ring_write": ("moshi_tpu_torch/csrc/ring_write.cu",
                   "moshi_tpu/nn/pallas_ring.py:64", "sts"),
    "attn_ffn_fused": ("moshi_tpu_torch/csrc/attn_ffn_fused.cu",
                       "moshi_tpu/quant/pallas_fused.py:249", "sts"),
    "decode_attention4": ("moshi_tpu_torch/csrc/decode_attention.cu",
                          "moshi_tpu/nn/pallas_attention.py:99", "stt"),
    "ring_write4": ("moshi_tpu_torch/csrc/ring_write.cu",
                    "moshi_tpu/nn/pallas_ring.py:99", "stt"),
    "qmatmul": ("moshi_tpu_torch/csrc/dequant_matvec.cu",
                "moshi_tpu/quant/pallas_matmul.py:332", "pool"),
    "glu_matvec": ("moshi_tpu_torch/csrc/glu_matvec.cu",
                   "moshi_tpu/quant/pallas_matmul.py:775", "pool"),
    "glu_matmul": ("moshi_tpu_torch/csrc/glu_matvec.cu",
                   "moshi_tpu/quant/pallas_matmul.py:553", "tts_pool"),
    "temporal_full_step": ("moshi_tpu_torch/csrc/temporal_step.cu",
                           "moshi_tpu/nn/pallas_temporal.py:390",
                           "sts_mega"),
    "dep_frame_step": ("moshi_tpu_torch/csrc/dep_step.cu",
                       "moshi_tpu/nn/pallas_depformer.py:555", "sts_mega"),
    "dep_full_step": ("moshi_tpu_torch/csrc/dep_step.cu",
                      "moshi_tpu/nn/pallas_depformer.py:280,137",
                      "dep_mega"),
    "decode_attention_mxu": ("moshi_tpu_torch/csrc/decode_attention.cu",
                             "moshi_tpu/nn/pallas_attention.py:358",
                             "sts_mxu"),
    "int8_kseg": ("moshi_tpu_torch/csrc/split_matvec.cu",
                  "moshi_tpu/quant/pallas_matmul_int8.py:751", "sts_mxu"),
    "int8_split": ("moshi_tpu_torch/csrc/split_matvec.cu",
                   "moshi_tpu/quant/pallas_matmul_int8.py:785", "lm_split"),
    "decode_attention_fp8": ("moshi_tpu_torch/csrc/decode_attention.cu",
                             "moshi_tpu/nn/pallas_attention.py:393",
                             "sts_fp8"),
    "ring_write_fp8": ("moshi_tpu_torch/csrc/ring_write.cu",
                       "moshi_tpu/nn/pallas_ring.py:64", "sts_fp8"),
    "decode_attention4_fp8": ("moshi_tpu_torch/csrc/decode_attention.cu",
                              "moshi_tpu/nn/pallas_attention.py:99",
                              "stt_fp8"),
    "ring_write4_fp8": ("moshi_tpu_torch/csrc/ring_write.cu",
                        "moshi_tpu/nn/pallas_ring.py:99", "stt_fp8"),
    "int8_matvec_i8": ("moshi_tpu_torch/csrc/int8_matvec.cu",
                       "moshi_tpu/quant/pallas_matmul_int8.py:829",
                       "sts_i8"),
    "attn_ffn_fused_i8": ("moshi_tpu_torch/csrc/attn_ffn_fused.cu",
                          "moshi_tpu/quant/pallas_fused.py:249", "sts_i8"),
    "temporal_full_step_fp8": ("moshi_tpu_torch/csrc/temporal_step.cu",
                               "moshi_tpu/nn/pallas_temporal.py:390",
                               "sts_mega_fp8"),
}
# the key of a check row's calls per frame of each path's frame
_CALLS = {"sts": "calls_per_frame", "stt": "calls_per_frame",
          "pool": "calls_per_tick", "tts_pool": "calls_per_tts_tick",
          "sts_mega": "calls_per_mega_frame",
          "dep_mega": "calls_per_dep_mega_frame",
          "sts_mxu": "calls_per_mxu_frame",
          "lm_split": "calls_per_split_frame",
          "sts_fp8": "calls_per_fp8_frame", "pool_fp8": "calls_per_fp8_tick",
          "stt_fp8": "calls_per_fp8_stt_frame",
          "sts_i8": "calls_per_i8_frame",
          "sts_mega_fp8": "calls_per_mega_fp8_frame"}


def path_sums(rows):
    """Per kernel, per path whose frame the check rows give calls for (the
    kernel's own path and the pool paths): the per-frame sums of ms,
    plain_ms, bound_ms and library_ms, as ``kernel_table`` forms them for
    the kernel's own path (None where a row lacks the figure)."""
    out = {}
    for name, (_, _, own) in _SOURCES.items():
        for path, calls in _CALLS.items():
            if calls == "calls_per_frame" and path != own:
                continue          # "sts" and "stt" share the key
            mine = [r for r in rows if r["kernel"] == name
                    and r.get(calls, 0) > 0]
            if mine:
                out.setdefault(name, {})[path] = {
                    key: (sum(r[key] * r[calls] for r in mine)
                          if all(key in r for r in mine) else None)
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return out


def kernel_table(rows, launches):
    """One entry per kernel: times and bounds for one frame's launches at
    the measured shapes (sum over shapes of the per-call figure times the
    calls each frame makes; the temporal attention at a full ring), and
    ``launches`` per frame as counted on the kernel's path (``launches``
    maps each path, "sts", "stt", "pool", "tts", "tts_pool", the knob and
    megakernel paths, the fp8 ones, the scans, the session, "load" (the 7B
    LM frame from a loaded GGUF) and "tts_demux", to its counts; a "pool" or
    "pool_fp8" frame is one tick of the B = POOL_B pool, a "tts_pool"
    frame one tick of the TTS pool).  ``paths`` gives the
    kernel's launches per frame on every path that launches it.  In the
    fused form K1's out_proj and GLU shapes have no calls."""
    table = []
    sums = path_sums(rows)
    for name, (src, replaces, path) in _SOURCES.items():
        mine = [r for r in rows if r["kernel"] == name
                and r.get(_CALLS[path], 0) > 0]
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": path,
            "launches": launches[path].get(name, 0),
            "paths": {p: c[name] for p, c in launches.items()
                      if c.get(name)},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in mine) else "operations",
            **sums[name][path],
        })
    return table


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every number of the run to this JSON "
                         "file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models.lm import LMConfig, init_gen_state
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.runtime.synth import (synth_lm_params,
                                               synth_mimi_params, tree_nbytes)

    global CARD
    smi = CARD = smi_line()
    device = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    report = {"card": smi, "device": device,
              "torch": torch.__version__, "cuda": torch.version.cuda}

    def phase(title):
        now = time.perf_counter() - t_start
        report.setdefault("phase_s", []).append((title.split(":")[0], now))
        log(f"{title}  [{now:.1f} s]")

    t_start = time.perf_counter()
    phase("phase 2: build")
    build_s = build.build_all()
    log(f"  kernels built in {build_s:.2f} s (nvcc, one process per "
        f"source)")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    report["build_s"] = build_s

    cfg = LMConfig(delays=_7B_DELAYS)
    t0 = time.perf_counter()
    params = synth_lm_params(cfg, "q4_k", device=DEV, seed=SEED)
    sync()
    log(f"  7B q4_k weights made in {time.perf_counter() - t0:.2f} s, "
        f"{tree_nbytes(params) / 2 ** 30:.3f} GiB")
    report["weights_bytes"] = tree_nbytes(params)
    scfg = stt_config()
    t0 = time.perf_counter()
    sparams = synth_lm_params(scfg, None, device=DEV, seed=SEED)
    sync()
    log(f"  stt-1b dense bf16 weights made in {time.perf_counter() - t0:.2f} "
        f"s, {tree_nbytes(sparams) / 2 ** 30:.3f} GiB")
    report["stt_weights_bytes"] = tree_nbytes(sparams)

    phase("phase 3: kernels against their plain versions at the 7B shapes")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    rows = check_matvecs(params, cfg, gen)
    rows += check_attention(cfg, gen)
    rows += check_fused(params, cfg, gen)
    phase("phase 3 (STT): K9 and K11 at the stt-1b shapes, the dense "
          "product")
    stt_rows, report["dense_products"] = check_stt_kernels(scfg, sparams,
                                                           gen)
    rows += stt_rows
    phase("phase 3 (rings): K11 (k and v in one launch, and one ring) and "
          "K4 against their plain versions, bf16 and fp8 rings, f32 and "
          "bf16 rows, B = 1 and 8, at offsets past the ring")
    # its own draws, so that every other phase's draws stay as they were
    report["ring_writes"] = check_ring_writes(
        scfg, cfg, torch.Generator(device=DEV).manual_seed(SEED + 33),
        POOL_B)
    phase(f"phase 3 (pool): K2, K6 and K8 at B = {POOL_B} (K6 and K8 also "
          f"at m = {POOL_M_EXTRA}), K3 and K4 with {POOL_B} session ages; "
          f"K6 and K2 on one-hot rows against every scale")
    # its own draws, so that the later phases' draws stay as they were
    pgen = torch.Generator(device=DEV).manual_seed(SEED + 18)
    rows += check_pool_matvecs(params, cfg, pgen, POOL_B)
    rows += check_pool_attention(cfg, pgen, POOL_B)
    report["dequant_probe"] = check_dequant_probe()
    tcfg = tts_config()
    t0 = time.perf_counter()
    tparams = synth_lm_params(tcfg, "q4_k", device=DEV, seed=SEED)
    sync()
    log(f"  TTS class q4_k weights made in {time.perf_counter() - t0:.2f} "
        f"s, {tree_nbytes(tparams) / 2 ** 30:.3f} GiB")
    report["tts_weights_bytes"] = tree_nbytes(tparams)
    phase(f"phase 3 (TTS): K1 at {list(TTS_ROWS)} rows, K7 at B = {POOL_B} "
          f"(and m = {POOL_M_EXTRA}), K9 and K11 with {POOL_B} session "
          f"ages on the TTS ring")
    tgen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    rows += check_k1_rows(tparams, tcfg, tgen)
    rows += check_k7(tparams, tcfg, tgen, POOL_B)
    rows += check_tts_ring_kernels(tcfg, tgen, POOL_B)
    phase(f"phase 3 (tts_pool): K6, K2 and K8 at the TTS pool's products, "
          f"B = {POOL_B} (K6 and K8 also at m = {POOL_M_EXTRA})")
    # their own draws, so that the later phases' draws stay as they were
    rows += check_tts_pool_matvecs(tparams, tcfg, POOL_B)
    phase("phase 3 (sts_mega, dep_mega): K13, K14a and K14c against their "
          "plain versions at the 7B shapes")
    # their own draws, so that the earlier phases' draws stay as they were
    rows += check_megakernels(params, cfg, torch.Generator(
        device=DEV).manual_seed(SEED + 20))
    phase(f"phase 3 (sts_mxu, lm_split): K10 at B = 1 and B = {POOL_B}, "
          f"K12 in both forms, against their plain versions at the 7B "
          f"shapes")
    rows += check_mxu_kernels(params, cfg, torch.Generator(
        device=DEV).manual_seed(SEED + 23))
    phase("phase 3 (workspace): K3 (bf16 and fp8 rings), K10 and K9 (bf16 "
          "and fp8 rings) twice on the same workspace, shapes changing "
          "between the pairs")
    # its own draws, so that every other phase's draws stay as they were
    report["attention_workspace"] = check_attention_workspace(
        cfg, torch.Generator(device=DEV).manual_seed(SEED + 28), POOL_B)
    report["k9_workspace"] = check_k9_workspace(
        scfg, tcfg, torch.Generator(device=DEV).manual_seed(SEED + 32),
        POOL_B)
    report["kernel_checks"] = rows

    phase("phase 4: card against CPU: 2 layers of the 7B geometry in both "
          "fusion forms, then all 32 (fused)")
    report["two_layer"] = [compare_two_layers("1"), compare_two_layers("0")]
    report["full_depth"] = compare_full_depth(cfg, params)
    phase("phase 4 (STT): card against CPU: 2 layers of the stt-1b "
          "geometry, then all 16")
    report["stt_compare"] = compare_stt(scfg, sparams)
    phase(f"phase 4 (pool): card against CPU: 2 layers of the 7B geometry "
          f"at B = {POOL_B}, sessions at {POOL_B} ages")
    report["pool_two_layer"] = compare_pool_two_layers(POOL_B)
    phase("phase 4 (TTS): card against CPU: 2 layers of the TTS class at "
          f"B = 1 with a voice (synthetic: {TTS_S} speaker rows of width "
          f"{TTS_DW}), at B = {POOL_B} through TTSSessionPool, then all "
          f"{tcfg.num_layers} at B = 1")
    # the TTS pool decodes with Mimi at the TTS class's n_q
    mimi_tts = MimiModel(MimiConfig(n_q=tcfg.n_q))
    mparams_tts = synth_mimi_params(mimi_tts.cfg, device=DEV, seed=SEED + 2)
    report["tts_two_layer"] = compare_tts_two_layers()
    report["tts_pool_two_layer"] = compare_tts_pool_two_layers(
        mimi_tts, mparams_tts, POOL_B)
    report["tts_full_depth"] = compare_tts_full_depth(tcfg, tparams)
    phase("phase 4 (sts_mega): card against CPU: 2 layers of the 7B "
          "geometry under MOSHI_TPU_MEGAKERNEL=all, fresh and on a full ring")
    report["mega_two_layer"] = compare_mega_two_layers()
    phase(f"phase 4 (dep_mega): card against CPU: 2 layers of the 7B "
          f"geometry at card {MEGA_K14A_CARD} under MOSHI_TPU_MEGAKERNEL=dep "
          f"(K14a)")
    report["dep_mega_two_layer"] = compare_dep_mega_two_layers()
    phase("phase 4 (sts_mxu, lm_split): card against CPU: 2 layers of the "
          "7B geometry under MOSHI_TPU_ATTN_MXU=1 with MOSHI_TPU_KSEG=1, "
          "fresh and on a full ring, then with MOSHI_TPU_SPLIT_SPREAD=1")
    report["mxu_two_layer"] = compare_mxu_two_layers()

    phase("phase 5: 7B q4_k lm_gen_step")
    nl = cfg.num_layers
    fresh_floor = hbm_floor_ms(rows, "temporal, path state (16 positions)",
                               nl)
    report["lm_7b"] = run_lm(
        cfg, params, "fresh session", init_gen_state(cfg, 1, device=DEV),
        fresh_floor)
    report["lm_7b_full_ring"] = run_lm(
        cfg, params, "full ring", long_session_state(cfg, gen),
        hbm_floor_ms(rows, "temporal, full ring", nl))
    # the two fusion forms side by side, in turns (fused, unfused,
    # unfused, fused), so that a drift of the host's speed during the
    # call weighs on both alike
    unfused_floor = hbm_floor_ms(
        rows, "temporal, path state (16 positions)", nl, fused=False)
    report["lm_7b_unfused"] = [
        run_lm(cfg, params, "fresh session, unfused",
               init_gen_state(cfg, 1, device=DEV), unfused_floor,
               fused=False) for _ in range(2)]
    report["lm_7b_fused_again"] = run_lm(
        cfg, params, "fresh session, fused again",
        init_gen_state(cfg, 1, device=DEV), fresh_floor)
    fused_ms = [report["lm_7b"]["ms_per_frame_mean"],
                report["lm_7b_fused_again"]["ms_per_frame_mean"]]
    unfused_ms = [r["ms_per_frame_mean"] for r in report["lm_7b_unfused"]]
    log(f"  fresh session in turns, ms/frame mean: fused {fused_ms[0]:.3f}, "
        f"unfused {unfused_ms[0]:.3f}, unfused {unfused_ms[1]:.3f}, fused "
        f"{fused_ms[1]:.3f}  [{CARD}]")
    phase("phase 5 (sts_mega): 7B q4_k lm_gen_step under "
          "MOSHI_TPU_MEGAKERNEL=all, in turns with the default form")
    turns, labels = [], ("megakernels", "default", "default", "megakernels")
    for turn in labels:
        if turn == "default":
            turns.append(run_lm(
                cfg, params, "fresh session, default form",
                init_gen_state(cfg, 1, device=DEV), fresh_floor))
            continue
        with megakernel("all"):
            turns.append(run_lm(
                cfg, params, "fresh session, megakernels",
                init_gen_state(cfg, 1, device=DEV, params=params),
                fresh_floor, per_frame=mega_launches(cfg)))
    report["lm_7b_mega_turns"] = turns
    log("  fresh session in turns, ms/frame mean: " + ", ".join(
        f"{t} {r['ms_per_frame_mean']:.3f}" for t, r in zip(labels, turns))
        + f"  [{CARD}]")
    with megakernel("all"):
        state = flat_long_session(
            cfg, init_gen_state(cfg, 1, device=DEV, params=params),
            torch.Generator(device=DEV).manual_seed(SEED + 21))
        report["lm_7b_mega_full_ring"] = run_lm(
            cfg, params, "full ring, megakernels", state,
            hbm_floor_ms(rows, "temporal, full ring", nl),
            per_frame=mega_launches(cfg))
        del state
    phase("phase 5 (sts_mxu, lm_split): 7B q4_k lm_gen_step under the "
          "K10 and K12 knobs, in turns with the default form")
    turns, labels = [], ("sts_mxu", "default", "default", "sts_mxu")
    for turn in labels:
        if turn == "default":
            turns.append(run_lm(
                cfg, params, "fresh session, default form",
                init_gen_state(cfg, 1, device=DEV), fresh_floor))
            continue
        with knobs("sts_mxu"):
            turns.append(run_lm(
                cfg, params, "fresh session, sts_mxu",
                init_gen_state(cfg, 1, device=DEV), fresh_floor,
                per_frame=mxu_launches(cfg)))
    report["lm_7b_mxu_turns"] = turns
    log("  fresh session in turns, ms/frame mean: " + ", ".join(
        f"{t} {r['ms_per_frame_mean']:.3f}" for t, r in zip(labels, turns))
        + f"  [{CARD}]")
    full_floor = hbm_floor_ms(rows, "temporal, full ring", nl)
    # its own draws, so that the later phases' draws stay as they were
    mgen = torch.Generator(device=DEV).manual_seed(SEED + 24)
    for path in ("sts_mxu", "lm_split"):
        with knobs(path):
            if path == "lm_split":
                report["lm_7b_split"] = run_lm(
                    cfg, params, "fresh session, lm_split",
                    init_gen_state(cfg, 1, device=DEV), fresh_floor,
                    per_frame=mxu_launches(cfg, path))
            report[f"lm_7b_{path}_full_ring"] = run_lm(
                cfg, params, f"full ring, {path}",
                long_session_state(cfg, mgen), full_floor,
                per_frame=mxu_launches(cfg, path))
    phase("phase 5 (STT): stt-1b dense lm_gen_step")
    # the timed frames read offset + 1 ring rows each
    stt_fresh_floor = stt_floor_ms(scfg, sparams, WARMUP + (FRAMES + 1) / 2)
    stt_full_floor = stt_floor_ms(scfg, sparams, scfg.context)
    report["lm_stt"] = run_lm(
        scfg, sparams, "fresh session", init_gen_state(scfg, 1, device=DEV),
        stt_fresh_floor, per_frame=stt_launches(scfg), model="stt-1b bf16")
    report["lm_stt_full_ring"] = run_lm(
        scfg, sparams, "full ring", long_session_state(scfg, gen),
        stt_full_floor, per_frame=stt_launches(scfg), model="stt-1b bf16")

    phase("phase 6: full-width Mimi, card against CPU")
    mimi = MimiModel(MimiConfig(n_q=cfg.n_q))
    mparams = synth_mimi_params(mimi.cfg, device=DEV, seed=SEED + 1)
    log(f"  Mimi bf16 weights {tree_nbytes(mparams) / 2 ** 20:.1f} MiB")
    report["mimi"] = compare_mimi(mimi, mparams)

    phase("phase 7: STS frame (STSPipeline: Mimi encode, 7B LM, Mimi "
          "decode)")
    report["sts"] = run_sts(cfg, params, mimi, mparams, fresh_floor)
    phase("phase 7 (STT): STT frame (STTPipeline: Mimi encode at n_q 32, "
          "the stt-1b LM)")
    # the same Mimi weights: the tree holds all 32 codebooks
    mimi32 = MimiModel(MimiConfig(n_q=scfg.n_q))
    report["stt"] = run_stt(scfg, sparams, mimi32, mparams, stt_fresh_floor)
    phase(f"phase 7 (sts_scan, stt_scan, session): the offline scans "
          f"(STSPipeline / STTPipeline.scan_frames, {SCAN_FRAMES} frames) "
          f"against the frame loop, 2 layers card against CPU, a "
          f"mid-stream scan, LMGenerator and MimiStreamer")
    held, report["sts_scan"] = run_sts_scan(
        cfg, params, mimi, mparams, report["sts"]["ms_per_frame_mean"])
    report["profile_scan"] = profile_scan(held, mparams, params)
    del held
    report["scan_mid_stream"] = run_scan_mid_stream(cfg, params, mimi,
                                                    mparams)
    report["stt_scan"] = run_stt_scan(scfg, sparams, mimi32, mparams,
                                      report["stt"]["ms_per_frame_mean"])
    report["scan_two_layer"] = compare_scan_two_layers(mimi, mparams, mimi32)
    report["session"] = run_session(cfg, params)
    report["mimi_streamer"] = check_mimi_streamer(mimi, mparams,
                                                  cfg.runtime_dep_q)
    phase(f"phase 7 (pool): SessionPool, {POOL_B} sessions of the 7B q4_k "
          f"STS frame")
    report["pool"], pool, pool_audio = run_pool(cfg, params, mimi, mparams,
                                                POOL_B)
    phase("phase 7 (TTS): the TTS frame (TTSPipeline.step_device with a "
          "voice) in q4_k and bf16, and TTSSessionPool at "
          f"B = {POOL_B}")
    cap = tcfg.transformer.mha.cap
    report["tts"] = run_tts(
        tcfg, tparams, mimi_tts, mparams_tts,
        tts_floor_ms(tcfg, tparams, min(cap, TTS_WARMUP
                                        + (TTS_FRAMES + 1) / 2)))
    report["tts_session"] = run_tts_session(tcfg, tparams, mimi_tts,
                                            mparams_tts)
    report["tts_pool"], tts_pool = run_tts_pool(tcfg, tparams, mimi_tts,
                                                mparams_tts, POOL_B)
    report["tts_pool"]["lm_hbm_floor_ms"] = tts_floor_ms(
        tcfg, tparams, TTS_POOL_TICKS / 2, batch=POOL_B)
    t0 = time.perf_counter()
    tparams16 = synth_lm_params(tcfg, None, device=DEV, seed=SEED)
    sync()
    log(f"  TTS class bf16 weights made in {time.perf_counter() - t0:.2f} "
        f"s, {tree_nbytes(tparams16) / 2 ** 30:.3f} GiB")
    report["tts_bf16"] = run_tts(
        tcfg, tparams16, mimi_tts, mparams_tts,
        tts_floor_ms(tcfg, tparams16, TTS_BF16_WARMUP
                     + (TTS_BF16_FRAMES + 1) / 2), bf16=True)
    # profiled here, while its weights are on the card
    report["profile_tts_bf16"] = profile_tts(tcfg, tparams16, mimi_tts,
                                             mparams_tts, bf16=True)
    del tparams16
    phase("phase 7 (sts_mega): the STS frame under MOSHI_TPU_MEGAKERNEL=all "
          "(STSPipeline.init_state with the LM weights)")
    with megakernel("all"):
        report["sts_mega"] = run_sts(cfg, params, mimi, mparams,
                                     fresh_floor, mega=True)
    phase("phase 7 (sts_mxu): the STS frame under MOSHI_TPU_ATTN_MXU=1 "
          "with MOSHI_TPU_KSEG=1")
    with knobs("sts_mxu"):
        report["sts_mxu"] = run_sts(cfg, params, mimi, mparams, fresh_floor,
                                    per_frame=mxu_launches(cfg),
                                    label="STS frame, sts_mxu")
    phase("phase 8: profile")
    # in turns, as in phase 5
    report["profile"] = profile_frames(cfg, params)
    report["profile_unfused"] = [profile_frames(cfg, params, fused=False)
                                 for _ in range(2)]
    report["profile_fused_again"] = profile_frames(cfg, params)
    report["profile_sts"] = profile_sts(cfg, params, mimi, mparams)
    report["profile_stt"] = profile_stt(scfg, sparams, mimi32, mparams)
    report["profile_pool"] = profile_pool(pool, pool_audio)
    del pool
    report["profile_tts"] = profile_tts(tcfg, tparams, mimi_tts, mparams_tts)
    report["profile_tts_pool"] = profile_tts_pool(tts_pool)
    del tts_pool
    with megakernel("all"):
        report["profile_mega"] = profile_frames(cfg, params, mega=True)
        report["profile_sts_mega"] = profile_sts(cfg, params, mimi, mparams,
                                                 mega=True)
    with knobs("sts_mxu"):
        report["profile_mxu"] = profile_frames(cfg, params, label="sts_mxu")
    phase("phase 8 (load): the 7B q4_k tree and the full Mimi through GGUF "
          "on the card, then quantize on load (bf16 safetensors, 2 "
          "7B-width layers, the native quantizer built on this host)")
    report["load"] = run_load(cfg, params, mimi, mparams)
    phase("phase 8 (tts_demux): the TTS class with the demuxed text stream "
          "and depformer RoPE, 2 layers card against CPU, then all "
          f"{tcfg.num_layers} layers through TTSPipeline.step_device")
    report["tts_demux_two_layer"] = compare_tts_demux_two_layers(
        mimi_tts, mparams_tts)
    report["tts_demux"] = run_tts_demux(mimi_tts, mparams_tts)

    phase(f"phase 9 (sts_fp8, pool_fp8, stt_fp8): fp8 KV rings: K4, K3 at "
          f"B = 1 and B = {POOL_B}, K9 and K11 against their plain versions")
    # its own generator, so that every other phase's draws stay as they
    # were.  SEED + 25 also seeds phase 3's TTS-pool K6/K2 generator, a
    # separate object: no draw of either phase moves the other's.  The
    # first free offset is SEED + 27 (SEED + 28 and SEED + 32 seed phase
    # 3's workspace checks); on SEED + 27's draws K3's check reads 5.04e-4
    # (see TOL's decode_attention)
    fgen = torch.Generator(device=DEV).manual_seed(SEED + 25)
    rows += check_fp8_kernels(cfg, scfg, fgen, POOL_B)
    phase(f"phase 9 (fp8): card against CPU on fp8 rings: 2 layers of the "
          f"7B geometry across the ring's wrap, at B = {POOL_B}, all 32 "
          f"layers, and 2 layers of the stt-1b geometry")
    report["fp8_compare"] = compare_fp8(cfg, params, scfg, POOL_B)
    phase("phase 9 (sts_fp8): 7B lm_gen_step on a full fp8 ring, the STS "
          "frame on fp8 rings")
    fcfg = fp8_config(cfg)
    report["lm_7b_fp8_full_ring"] = run_lm(
        fcfg, params, "full ring, fp8 rings", long_session_state(fcfg, fgen),
        fp8_floor_ms(rows, "temporal, full ring", nl),
        per_frame=fp8_launches(per_frame_launches(fcfg), nl))
    report["sts_fp8"] = run_sts(
        fcfg, params, mimi, mparams,
        fp8_floor_ms(rows, "temporal, path state (16 positions)", nl),
        per_frame=fp8_launches(per_frame_launches(fcfg), nl),
        label="STS frame, fp8 rings")
    phase(f"phase 9 (pool_fp8): SessionPool, {POOL_B} sessions on fp8 rings")
    report["pool_fp8"], pool, _ = run_pool(
        fcfg, params, mimi, mparams, POOL_B,
        per_tick=fp8_launches(pool_launches(fcfg, params), nl),
        label="SessionPool, fp8 rings")
    del pool
    report["fp8_memory"] = fp8_memory(cfg, tree_nbytes(params),
                                      report["pool"], report["pool_fp8"])
    phase("phase 9 (stt_fp8): the STT frame on fp8 rings")
    sfcfg = fp8_config(scfg)
    report["stt_fp8"] = run_stt(
        sfcfg, sparams, mimi32, mparams, stt_fresh_floor,
        per_frame=fp8_launches(stt_launches(sfcfg), 0),
        label="STT frame, fp8 rings")
    report["profile_stt_fp8"] = profile_stt(sfcfg, sparams, mimi32, mparams,
                                            label="STT frame, fp8 rings")

    phase("phase 10 (sts_i8): K1 and K5 on unpacked-i8 weights at the 7B's "
          "products, the frames against the packed weights', the LM frame "
          "in turns and the STS frame")
    from moshi_tpu_torch.quant.formats import i8_storage_tree
    iparams = i8_storage_tree(params)
    sync()
    added = tree_nbytes(iparams) - tree_nbytes(params)
    log(f"  i8 storage: {added} bytes ({added / 1e9:.4f} GB) more than the "
        f"packed weights, {tree_nbytes(iparams) / 2 ** 30:.3f} GiB in all")
    report["i8_weights_bytes"] = tree_nbytes(iparams)
    # its own generator, so that every other phase's draws stay as they
    # were
    igen = torch.Generator(device=DEV).manual_seed(SEED + 29)
    rows += check_i8_kernels(params, iparams, cfg, igen)
    report["i8_frames"] = compare_i8_frames(cfg, params, iparams, igen)
    # every i8 leaf is read once a frame: its added bytes add to the floor
    i8_floor = fresh_floor + added / HBM_BYTES_PER_S * 1e3
    per_i8 = i8_launches(per_frame_launches(cfg))
    turns, labels = [], ("i8", "packed", "packed", "i8")
    for turn in labels:
        i8 = turn == "i8"
        turns.append(run_lm(
            cfg, iparams if i8 else params, f"fresh session, {turn} weights",
            init_gen_state(cfg, 1, device=DEV), i8_floor if i8
            else fresh_floor, per_frame=per_i8 if i8 else None))
    report["lm_7b_i8_turns"] = turns
    log("  fresh session in turns, ms/frame mean: " + ", ".join(
        f"{t} {r['ms_per_frame_mean']:.3f}" for t, r in zip(labels, turns))
        + f"  [{CARD}]")
    report["sts_i8"] = run_sts(cfg, iparams, mimi, mparams, i8_floor,
                               per_frame=per_i8,
                               label="STS frame, i8 weights")
    same = report["sts_i8"]["digests"] == report["sts"]["digests"]
    report["sts_i8"]["digests_equal_phase7"] = same
    log(f"  the STS frames' digests equal phase 7's (the same audio, seeds "
        f"and sampling): {same}  [{CARD}]")
    # each frame's own memory: its LM weights, Mimi's, and its run's peak
    # over the memory live before it (both weight trees are live here)
    own = {name: (w + tree_nbytes(mparams) + r["peak_memory_bytes"]
                  - r["live_before_bytes"])
           for name, w, r in (("packed", tree_nbytes(params), report["sts"]),
                              ("i8", tree_nbytes(iparams),
                               report["sts_i8"]))}
    report["sts_i8"]["own_memory_bytes"] = own
    log(f"  the STS frame's own memory (its LM weights, Mimi's, its peak "
        f"over the live memory): packed {own['packed'] / 2 ** 30:.3f} GiB, "
        f"i8 {own['i8'] / 2 ** 30:.3f} GiB, {own['i8'] - own['packed']} "
        f"bytes more  [{CARD}]")
    del iparams
    phase("phase 10 (sts_mega_fp8): K13 on fp8 flat rings against its plain "
          "version and its bf16 instance, 2 layers card against CPU, the LM "
          "and the STS frames under MOSHI_TPU_MEGAKERNEL=all")
    rows += check_k13_fp8(params, cfg, torch.Generator(
        device=DEV).manual_seed(SEED + 30))
    report["mega_fp8_two_layer"] = compare_mega_fp8_two_layers()
    with megakernel("all"):
        report["lm_7b_mega_fp8"] = run_lm(
            fcfg, params, "fresh session, megakernels, fp8 rings",
            init_gen_state(fcfg, 1, device=DEV, params=params),
            fp8_floor_ms(rows, "temporal, path state (16 positions)", nl),
            per_frame=mega_fp8_launches(cfg))
        state = flat_long_session(
            fcfg, init_gen_state(fcfg, 1, device=DEV, params=params),
            torch.Generator(device=DEV).manual_seed(SEED + 31))
        report["lm_7b_mega_fp8_full_ring"] = run_lm(
            fcfg, params, "full ring, megakernels, fp8 rings", state,
            fp8_floor_ms(rows, "temporal, full ring", nl),
            per_frame=mega_fp8_launches(cfg))
        del state
        report["sts_mega_fp8"] = run_sts(
            fcfg, params, mimi, mparams,
            fp8_floor_ms(rows, "temporal, path state (16 positions)", nl),
            mega=True, per_frame=mega_fp8_launches(cfg),
            label="STS frame, megakernels, fp8 rings")
    table = kernel_table(rows, {
        "sts": report["sts"]["launches_per_frame"],
        "stt": report["stt"]["launches_per_frame"],
        "pool": report["pool"]["launches_per_tick"],
        "tts": report["tts"]["launches_per_frame"],
        "tts_pool": report["tts_pool"]["launches_per_tick"],
        "sts_mega": report["sts_mega"]["launches_per_frame"],
        "dep_mega": report["dep_mega_two_layer"]["launches_per_frame"],
        "sts_mxu": report["sts_mxu"]["launches_per_frame"],
        "lm_split": report["lm_7b_split"]["launches_per_frame"],
        "sts_fp8": report["sts_fp8"]["launches_per_frame"],
        "pool_fp8": report["pool_fp8"]["launches_per_tick"],
        "stt_fp8": report["stt_fp8"]["launches_per_frame"],
        "sts_i8": report["sts_i8"]["launches_per_frame"],
        "sts_mega_fp8": report["sts_mega_fp8"]["launches_per_frame"],
        "sts_scan": report["sts_scan"]["launches_per_frame"],
        "stt_scan": report["stt_scan"]["launches_per_frame"],
        "session": report["session"]["launches_per_frame"],
        "load": report["load"]["launches_per_frame"],
        "tts_demux": report["tts_demux"]["launches_per_frame"]})
    report["kernels"] = table
    report["kernel_path_sums"] = path_sums(rows)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    log(f"done  [{time.perf_counter() - t_start:.1f} s]")
    log(json.dumps({"kernels": table}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
