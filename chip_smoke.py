#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mmgl_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU with nvcc (on PATH or in $CUDA_HOME/bin) and
imports no JAX. Phases, each fatal on failure:

  1. the card: CUDA visible, its name and power limit from nvidia-smi;
  2. build the kernels from mmgl_tpu_torch/csrc (time, ptxas report);
  3. each kernel against its plain version on the card, bf16, fp16 and
     fp32, with pad holes and fully masked rows: K1 and K2 forward and K3
     (K1's backward) at the OPT shapes, and K1 at Roberta's (44, 512, 12,
     64) over right-padded neighbor texts with an empty slot, at
     OPT-1.3B + LoRA's 684 tokens (32 heads) and its 556-token prefill,
     and at prompt tuning's 724 tokens and its 596-token prefill; K2 causal
     at the CLIP text tower's (44, 77, 8, 64) over right-padded texts with
     an empty one, and with a pad hole; K4 and K5
     (forward and gradient) at T5-base's cross-attention, with an MQA head,
     at MPT-1.3B's cross-attention (640 queries, 64 memory keys, 32 heads,
     a sample without neighbours) and its prefill's 512 queries against
     the memory, and at prefix tuning's 704 queries
     against 724 keys, causal; K7 with K8/K9 (dbias included) at T5-base's
     encoder, decoder and cross-attention shapes, at the embedding mode's
     576-token encoder and at the prefixed decoder's 128 x 148 (ragged
     bias), each without and with dropout 0.1; ragged lengths for every
     kernel.
     The dropout mask K7 draws is read off its output, in every dtype, and
     compared with the plain version's bit for bit. At the encoder's shape
     with dropout, in bf16 and fp16, K7's row stats against the plain
     version's, and K8/K9 from them equal, bit for bit, to K8/K9 with its
     own stats pass. At head dims 80 and 128 (OPT and MPT at 2.7B,
     OPT-6.7B), bf16, fp16 and fp32: K1 and K3 at OPT-2.7B's and
     OPT-6.7B's (4, 640, 32, D) causal with a pad hole, K4 and K5 there and
     at MPT-2.7B's cross-attention (4, 640 x 64, 32, 80); K1 and K3-K6 at
     the 512-token prefills of MPT-2.7B (4, 512, 32, 80) and OPT-6.7B
     (4, 512, 32, 128) under right-padded prompts, K4 and K5 at MPT-2.7B's
     prefill cross-attention (4, 512 x 64, 32, 80); K4 with its row
     stats and K6 at the causal ones, a ragged 333 at each D, each against
     its plain version, K6 against K5 (bit for bit: one code in every
     dtype) and against K3 given the same
     stats (bit for bit in bf16 and fp16: K3's wgmma bodies), the half
     types on the tensor-core bodies. K1 and K3 on their wgmma/TMA bodies
     at lengths 1, 63, 64, 65, 127, 128, 129, 205 and 640 and at 100
     queries against 228
     keys (end-aligned), head dims 64, 80 and 128, bf16 and fp16, causal,
     with a pad gap, fully masked rows and a fully masked sample: K1 and
     its row max and sum against the plain versions, K3 against its plain
     version, and K3 from K1's stats equal, bit for bit, to K3 with its own
     stats pass;
  4. the OPT-125M + CLIP ViT-B/16 test pass at full width (task=section,
     context=all, raw neighbors, the --test pass of mmgl_tpu_torch.cli on
     the synthetic corpus with seeded random weights); K1 and K2 must launch
     in it. Then one sample's fp32 eval step on the card against the CPU;
  5. OPT training at the same width through the CLI (bf16, batch 4 x 4
     micro-batches, 4 updates, the val passes, the best checkpoint, the
     test pass on it restored): K1, K2 and K3 must launch inside the steps,
     losses and gradient norms be finite, every trainable tensor move and
     no tower tensor. Then one fp32 micro-step on the card against the CPU;
     5c. float16 compute end to end (--compute_dtype float16, fp32
     parameters) through the CLI: OPT-125M and T5-base, one update of 4 x
     4 each, a val batch before and after it, the best checkpoint and a
     test batch on it restored; the checks of phase 5. Then a T5-base
     float16 micro-step in eval mode (K4 and K5 at the cross-attention),
     every launch in it held against its plain version on the same inputs
     at phase 3's tolerance;
  6. the T5-base + CLIP test pass through the CLI (batch 4, 4 batches):
     every eval step launches K7 24 times (12 encoder, 12 decoder
     self-attention) and K4 12 times (cross), every generated batch K7 12
     times (the encoder) and K2 on every image (12 layers). Then one
     sample's fp32 eval step, card against CPU;
  7. T5-base training through the CLI (Adafactor, dropout 0.1, 4 updates of
     4 x 4): every micro-step launches K7 and K8/K9 36 times each; the
     checks of phase 5. Then one fp32 micro-step in eval mode (no dropout:
     K7, K8/K9, K4 and K5 on the card) against the CPU;
  8. every kernel timed (bf16 and fp16, CUDA events over runs of 10 calls
     back to back, 2 of the plain version's) against its plain version and against the one PyTorch
     call that
     computes the same function (scaled_dot_product_attention with the bias
     and mask as a float attn_mask, and its backward), beside its bound:
     max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s), each input read and each
     output written once, FLOPs over the pairs the masks leave (dropout's
     bits excluded); K8/K9 from K7's row stats, as training runs it; K4
     with its row stats, K6 and K5 also at OPT-350M's (4, 2048, 16, 64), K6
     and K5 again at (4, 1024, 16, 64); in bf16 also K1 at Roberta's shape
     and K7 and K9 at the 576-token encoder, and K1, K3-K6 at head dims 80
     and 128 (K1/K3 at (4, 640, 32, D), K4/K5 at (4, 640 x 64, 32, D), K4
     with its stats and K6 at (4, 1024, 32, D));
  9. OPT-350M + CLIP training at OPT's whole 2048-token window through the
     CLI (--max_input_length 1920 --max_output_length 128, bf16, 4 updates
     of 4 x 4, AdamW) with the blocked backward selected (the module flag
     that MMGL_BLOCKED_BWD=1 sets at import), for this phase only: every update launches K4 and K6 96 times each (24 layers x 4
     micro-batches) and K1, K3 and K5 none; every eval step and every
     generated batch (its 1920-token prefill) K4 24 times; the checks of
     phase 5. Then one sample's fp32 micro-step in eval mode, K4 and K6
     against the plain versions on the card (the CPU would take too long).
     Then the same training in float16, one update (the short run of 5c).
     K4 keeps its row stats in every launch inside the training steps, in
     bf16 and fp16 alike, and in no other (counted where it launches);
 10. the embedding mode at full width, BASELINE config 2: T5-base +
     Roberta-base + CLIP ViT-B/16, context section_all, 11 neighbor texts x
     512 tokens and 5 neighbor images a sample, 4 soft tokens each,
     appended to the 512-token encoder input (576 tokens). The test pass
     (batch 4, 4 batches): every eval step launches K1 12 times (Roberta,
     44 texts at once), K2 12 (20 images), K7 24 and K4 12; every generated
     batch K1, K2 and K7 12 times each. One sample's fp32 eval step, card
     against CPU. Training (Adafactor, dropout 0.1, 4 updates of 4 x 4):
     every update launches K1 and K2 48 times, K7 and K8/K9 144 (K9 at
     576 x 576), K3 none (Roberta runs without autograd); the checks of
     phase 5 (the text pooler, behind the text tower's stop_gradient, is
     trainable with a zero gradient and may stay). Then a bf16 micro-step
     in eval mode, where the cross-attention takes K4 and K5 (128 x 576)
     and the encoder K7 and K9 (576 x 576), each launch held against its
     plain version as in 5c;
 11. OPT-125M + Roberta-base + CLIP, context all, embedding, once with the
     Laplacian and once with the GCN position encoding, each the short run
     of 5c through the CLI; OPT's 640 + 64 = 704 tokens take K1 and K3,
     its 576-token prefill K1. (In training OPT's soft tokens sit after the
     summary, where the causal mask hides them from every labeled token, as
     in the JAX package: the encodings and projections get a zero gradient
     there, may stay, and act in the prefill that generation starts from.)
 12. BASELINE family 3 at its published LM width: OPT-1.3B + Roberta-base,
     context text_only, embedding, LoRA (r 64) on every q and v projection,
     --freeze_lm true; the short run of 5c. 640 + 11 x 4 = 684 tokens take
     K1 and K3 (8 of OPT-1.3B's 24 layers, full width), Roberta K1; the
     prefill at 556 K1. Then its
     fp32 micro-step on the card against the CPU and its bf16 one held
     launch by launch against the plain versions, LoRA's B set to seeded
     non-zero values in both (at init B is 0 and A's gradient is 0);
 13. BASELINE family 4 as the JAX package's bench runs it, at MPT-2.7B's
     width (head dim 80) and 8 of its 32 layers (as phase 18): +
     Roberta-base + CLIP, context all,
     flamingo, 4 gated cross layers (one after every 2nd layer), from
     cached tower features (--cache_neighbor_embeddings true
     --neighbor_cache_dir), the short run. The cache build launches
     Roberta's K1 and CLIP's K2; no micro-step, eval step or generated
     batch does. The self-attention takes K1 (8 layers) and K3 (6: the
     two layers before the first cross layer see no trainable input), at
     head dim 80; the cross-attention, 640 queries against the 64-token
     memory under its mask, K4 and K5 (4 each); the prefill K1 at 512 and
     K4 at 512 x 64; the decode steps' one query the plain route. A second
     start on the same cache directory launches no kernel. Then its fp32
     micro-step card against CPU and its bf16 one held launch by launch
     against the plain versions, the gates seeded non-zero, both from
     cached features;
 14. prefix and prompt tuning, each the short run: (a) family 5 without its
     mesh, OPT-125M + Roberta + CLIP, all, Laplacian, prefix: 704 queries
     against 20 + 704 keys, causal with the ends aligned, take K4 and K5;
     the prefill (no prefix, as in the JAX package) K1; (b) family 6,
     OPT-125M, GCN, prompt: 20 + 704 = 724 tokens take K1 and K3, the
     prefill at 596 K1; (c) BASELINE config 2 (T5-base) with prefix: the
     decoder's 128 queries against 20 + 128 keys with the position bias
     padded by zero columns take K7 and K8 at a ragged key length. Then an
     fp32 micro-step card against CPU for (a) and (b), and bf16 ones held
     launch by launch against the plain versions for (a), (b) and (c).
     (T5 takes no fp32 micro-step here: phase 7's covers its bodies, and a
     random-init T5's fp32 step on the CPU takes long.)
 15. the neighbour cache on the main path and on config 2: OPT-125M + CLIP
     raw all and T5-base + Roberta + CLIP section_all embedding, 4 updates
     each through the CLI with --cache_neighbor_embeddings true; the cache
     build launches CLIP's K2 (and config 2 Roberta's K1), no update, eval
     step or generated batch launches either. On one batch of 4 of each,
     in bf16: the cached pooled features (images_pooled; config 2's
     neighbor_text_pooled and neighbor_image_pooled) against
     model.pool_images / pool_text on the live batch's raw fields, within
     phase 3's bf16 atol of their largest entry and nearer each sample's
     own live features than its neighbour's; and the eval loss, cached
     against live, at phase 3's bf16 tolerance. The
     update seconds printed beside phases 5 and 10's;
 16. OPT-6.7B's test pass (head dim 128), raw all, bf16 parameters,
     through the CLI (batch 4, 4 batches), at 8 of its 32 layers (full
     width, for the time limit): every eval step and generated batch
     launches K1 8 times at head dim 128 and K2 12 times;
 17. the main path from a pretrained checkpoint: the script writes, from
     seeded numpy arrays under a temporary directory, OPT-125M in HF's
     layout as pytorch_model.bin (fp16, as HF stores OPT) and a CLIP
     ViT-B/16 CLIPModel (both towers) as model.safetensors, then runs the
     OPT test pass of phase 4 with --model_name_or_path and --visual_model
     naming them: every parameter of the LM and the vision tower equals
     the file's tensor under HF's names (the patch conv flattened to the
     (p, p, 3) patch order), K1 and K2 launch 12 times an eval step and
     generated batch on the tensor-core body, the loss is finite and not
     the seeded model's, and one sample's fp32 eval step on the card
     agrees with the CPU;
 18. BASELINE family 7 at full width and 8 of MPT-2.7B's 32 layers (as
     phase 13): MPT-2.7B + flamingo, context all,
     embedding, the CLIP text tower imported from phase 17's CLIPModel
     (--text_model; its vision tower too), --max_input_length 77
     (prompt and neighbour texts; the text tower's position table holds
     77), uncached: the short run, bf16 compute with fp32 parameters.
     Every micro-step launches K2 12 times causal at (44, 77, 8, 64) for
     the texts and 12 times at (20, 197, 12, 64) for the images, K1 8
     and K3 6 at head dim 80 (205 tokens), K4 and K5 4 at 205 x 64; the
     eval steps and prefills their own counts; the tanh gates move in
     update 1 while the cross layers behind them get exactly-zero
     gradients, and no frozen tensor moves. Then its fp32 micro-step card
     against CPU, the gates seeded;
 19. BASELINE family 3 as the JAX package's bench runs it: phase 12's run
     under --remat true (the same seed and batch). Every micro-step
     launches K1 twice a layer of the LM (the forward and the recompute,
     which replays the layer's dropout draws) beside Roberta's 12, and K3
     once a layer; update 1's loss and gradient norm equal phase 12's at
     phase 3's bf16 tolerance, and its peak is printed beside phase 12's.
     Then its bf16 micro-step with every launch, the recomputed ones too,
     held against its plain version;
 20. OPT-6.7B + LoRA as the JAX package's scripts/probe_67b.py trains it
     (section_only, raw, r 16, alpha 32, --freeze_lm true, bf16
     parameters, --remat true --chunked_ce 8, 512 + 128 tokens), at 8 of
     its 32 layers (full width, head dim 128): the short run, K1 twice and
     K3 once a layer in every micro-step at head dim 128 on the
     tensor-core bodies (K3's first launches at 128 on a path); its bf16
     micro-step held launch by launch against the plain versions, and the
     same sample's loss through the materialised logits against the
     chunked one at phase 3's bf16 tolerance; the peak printed;
 21. the main path (OPT-125M + CLIP) with this slice's other flags: the
     test pass with --layerdrop 0.1 gives phase 4's test loss bit for
     bit; one update with --layerdrop 0.5 launches K1 and K3 12 times a
     micro-step (compute, then select), prints the fraction of layers
     kept, and the layers bypassed in every micro-step get exactly-zero
     gradients; one update with --fused_ce false, --profile_dir and
     --log_to_wandb true: its train step calls the plain CE and never the
     fused one, its loss and gradient norm equal phase 5's first update at
     phase 3's bf16 tolerance, its Chrome trace holds device
     events of the port's wgmma bodies and none of the mma.sync forward
     that K2 ran before (its size and kernel events printed), and,
     wandb made unimportable (no network call), it prints
     "[wandb] disabled: ...".

Phases 12-16 check the launches of every update, eval step and generated
batch against the counts the layer layout gives, the tensor-core body of
every launch, and phases 12-15 that every trainable tensor moved but those named with the
reason they get a zero gradient in the one update (LoRA's A while B is 0;
MPT's cross layers and memory projections while the gates are 0; OPT's
soft-token projections behind the causal mask), and that every frozen
tensor (the LM under PEFT, the towers) stayed bit for bit.

Phase 3 also holds K4 with its row stats and K6 against their plain
versions at OPT-350M's shape with a pad hole and with a fully masked
sample, ragged and end-aligned sq < sk, and at OPT-350M's shape K6 against
K5 (bit for bit: K5 runs K6's code from its own stats pass)
and, in bf16 and fp16, K4's row stats equal to K1's and K6 equal to K3
given them, bit for bit (K6 runs K3's wgmma bodies). K2 at CLIP's 197
patches also runs without a mask (a null pointer). The launch counts are
set to 0 just before each path and read just after. Every kernel has two
bodies, tensor cores for bf16 and fp16 and scalar FMAs for fp32: phases 4,
5, 5c, 6, 7, 9, 10 and 11 (bf16 or fp16) check that every launch of K1-K9
took the tensor-core body, and their fp32 checks that none did.
Phase 3 also holds K4's wgmma body at its query lengths 63-2048 against
64-724 keys, head dims 64, 80 and 128 (K6 from its stats equal to K3
given them and to K5, bit for bit), and
K7's with an fp32 bias at T5's shapes (K8/K9 from its stats
equal to K8/K9 with its own stats pass, a row-padded bias the same bits as
a contiguous one), and K8/K9 on the bias form of K3's wgmma bodies:
without a bias or dropout equal to K3 given the same stats, bit for bit; a
profiled call at the encoder and one at the decoder that launch the wgmma
dQ and dK/dV bodies (two launches, one grid) and no delta pass or mma.sync
tile; and a causal case with a masked key tile whose
partial's block was filled with NaN just before (dbias finite, 0 where
every sample's logit is masked). K5 on K3's wgmma bodies after its stats
pass, bf16 and fp16: equal to K6 given K4's stats bit for bit at T5's
cross-attention (one grid) and MPT's (two launches), and a profiled call
at each that launches the wgmma dQ and dK/dV bodies and no delta pass or
mma.sync tile.
Phase 8 times K3 as training runs it, from K1's row stats.
Prints the seconds elapsed at the end of each phase (and a JSON line of
them), a kernels JSON line (each entry's "design" names its body:
"bias_tc" the bias form of K3's wgmma bodies (K8/K9), "wgmma_tma" K1's to
K6's, "wgmma_tma_bias" K7's;
the fp16 forms, the shapes of phases 12-14 and
the head dims 80 and 128 that phases 18 and 16 launch, and K2's causal
form at the CLIP text tower's shape that phase 18 launches, as entries of
their own), then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
fp32 comparisons run with TF32 off (cuBLAS and cuDNN), so the plain
versions compute in full fp32.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

OPT_TEST_ARGV = ["--model_name_or_path", "opt-125m", "--task", "section",
                 "--context", "all", "--neighbor_mode", "raw", "--test",
                 "true", "--bf16", "true", "--tokenizer_path", "byte:50272",
                 "--per_device_val_batch_size", "4", "--val_steps_per_epoch",
                 "4", "--seed", "0", "--device", "cuda"]
OPT_TRAIN_ARGV = ["--model_name_or_path", "opt-125m", "--task", "section",
                  "--context", "all", "--neighbor_mode", "raw",
                  "--bf16", "true", "--tokenizer_path", "byte:50272",
                  "--per_device_train_batch_size", "4",
                  "--grad_accumulation_steps", "4", "--steps_per_epoch", "16",
                  "--epochs", "1", "--per_device_val_batch_size", "4",
                  "--val_steps_per_epoch", "2", "--print_freq", "1",
                  "--seed", "0", "--device", "cuda"]
# T5-base: the same flags with its model name and its vocabulary
T5_TEST_ARGV = [a.replace("opt-125m", "t5-base").replace("byte:50272",
                                                         "byte:32128")
                for a in OPT_TEST_ARGV]
T5_TRAIN_ARGV = [a.replace("opt-125m", "t5-base").replace("byte:50272",
                                                          "byte:32128")
                 for a in OPT_TRAIN_ARGV]
# OPT-350M (post-LN, project_in/out) at its 2048-token position table
OPT350_TRAIN_ARGV = [a.replace("opt-125m", "opt-350m")
                     for a in OPT_TRAIN_ARGV] + [
    "--max_input_length", "1920", "--max_output_length", "128"]
TRAIN_UPDATES = 4
T5_LAYERS = 12
OPT350_LAYERS = 24
ROBERTA_LAYERS = 12
CLIP_LAYERS = 12
OPT_LAYERS = 12
# a depth cut at full width, for the script's time limit (1039-1303 s
# with it whole, by host): phases 12 and 19 (family 3) run OPT-1.3B at 8
# of its 24 layers (2048 wide, 32 heads of 64)
OPT13_LAYERS = 8
MPT_CROSS = 4               # --num_neighbor_layers: MPT-2.7B's 32 // 8
# a depth cut at full width, for the script's time limit (on a slow host
# the script took 1303 s with family 7 at its whole depth): phases 13 and
# 18 (families 4 and 7) run MPT-2.7B at 8 of its 32 layers (2560 wide, 32
# heads of 80). Cross layers one every 2, so the 6 self-attention layers
# after the first cross layer see a trainable input
MPT_CUT_LAYERS = 8
MPT_CUT_GRAD_LAYERS = MPT_CUT_LAYERS - MPT_CUT_LAYERS // MPT_CROSS
# a depth cut at full width, for the script's time limit (on a slow host
# the script took 948 s to phase 16 without it): OPT-6.7B's test pass runs
# 8 of its 32 layers (4096 wide, 32 heads of 128)
OPT67_LAYERS = 8
# phases 17 and 18: the checkpoint directories, named as a user names them
# (the factory selects the model by substrings of the name), relative to
# the directory the phases run in
CKPT_OPT = "opt-125m"
CKPT_CLIP = "clip-vit-base-patch16"


def with_flags(argv, **flags):
    """argv with each --flag's value replaced, or the flag appended."""
    out = list(argv)
    for key, value in flags.items():
        flag = "--" + key
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out


# BASELINE config 2, the embedding mode: T5-base + Roberta-base + CLIP
# ViT-B/16, context section_all, 11 text neighbors x 512 tokens and 5 image
# neighbors, 4 soft tokens each, appended to the 512-token encoder input
# (576 tokens); decoder 128
EMBEDDING = dict(context="section_all", neighbor_mode="embedding",
                 position_type="none", max_input_length=512,
                 max_output_length=128)
T5_EMB_TEST_ARGV = with_flags(T5_TEST_ARGV, **EMBEDDING)
T5_EMB_TRAIN_ARGV = with_flags(T5_TRAIN_ARGV, **EMBEDDING)
# a short run through the CLI: one update of 4 x 4 micro-batches, one val
# batch before and after it, one test batch
SHORT = dict(steps_per_epoch=4, val_steps_per_epoch=1)
# the graph paths: OPT-125M + Roberta-base + CLIP, context all, embedding,
# with the Laplacian or the GCN position encoding (640 + 64 = 704 tokens)
OPT_GRAPH_ARGV = {pt: with_flags(OPT_TRAIN_ARGV, context="all",
                                 neighbor_mode="embedding", position_type=pt,
                                 **SHORT)
                  for pt in ("laplacian", "gnn")}
# in OPT's training the soft tokens sit after the summary, where the causal
# mask hides them from every labeled token: their projections, position
# tables and encodings get a zero gradient (and the pooler none)
OPT_GRAPH_IDLE = ("text_embeddings.", "text_position_embeddings.",
                  "visual_embeddings.", "visual_position_embeddings.",
                  "lpe_embeddings.", "gnn.")
# float16 compute (fp32 parameters) on the tensor-core bodies
OPT_FP16_ARGV = with_flags(OPT_TRAIN_ARGV, compute_dtype="float16", **SHORT)
T5_FP16_ARGV = with_flags(T5_TRAIN_ARGV, compute_dtype="float16", **SHORT)
OPT350_FP16_ARGV = with_flags(OPT350_TRAIN_ARGV, compute_dtype="float16",
                              **SHORT)
# BASELINE family 3 at its published LM width: OPT-1.3B + Roberta-base,
# text_only, embedding, LoRA on q and v, --freeze_lm true (640 + 44 tokens)
LORA_ARGV = with_flags(OPT_TRAIN_ARGV, model_name_or_path="opt-1.3b",
                       context="text_only", neighbor_mode="embedding",
                       peft_type="lora", freeze_lm="true", **SHORT)
# family 4 at its published size, as the JAX package's bench runs it
# (scripts/bench_baseline_configs.py:38-60): MPT-2.7B + Roberta-base +
# CLIP, all, flamingo, from cached tower features (--neighbor_cache_dir is
# given at run time)
MPT_ARGV = with_flags(OPT_TRAIN_ARGV, model_name_or_path="mpt-2.7b",
                      context="all", neighbor_mode="embedding",
                      peft_type="flamingo", cache_neighbor_embeddings="true",
                      **SHORT)
# the main path (BASELINE config 1) and config 2 from cached tower features
OPT_CACHED_ARGV = with_flags(OPT_TRAIN_ARGV, cache_neighbor_embeddings="true")
T5_EMB_CACHED_ARGV = with_flags(T5_EMB_TRAIN_ARGV,
                                cache_neighbor_embeddings="true")
# OPT-6.7B's test pass (head dim 128), raw all, bf16 parameters (the fp32
# ones would be 27 GB on the host and on the card for a pass without
# gradients)
OPT67_TEST_ARGV = with_flags(OPT_TEST_ARGV, model_name_or_path="opt-6.7b",
                             param_dtype="bfloat16")
# family 5 without its mesh (prefix, Laplacian) and family 6 (prompt, GCN)
PREFIX_ARGV = with_flags(OPT_GRAPH_ARGV["laplacian"], peft_type="prefix")
PROMPT_ARGV = with_flags(OPT_GRAPH_ARGV["gnn"], peft_type="prompt")
# BASELINE config 2 with T5's decoder prefixes
T5_PREFIX_ARGV = with_flags(T5_EMB_TRAIN_ARGV, peft_type="prefix", **SHORT)
# the main path's test pass from HF-layout checkpoints (phase 17)
OPT_CKPT_TEST_ARGV = with_flags(OPT_TEST_ARGV, model_name_or_path=CKPT_OPT,
                                visual_model=CKPT_CLIP)
# BASELINE family 7 (tests/test_baseline_configs.py:41-47,
# "mpt-cliptext-all") at its published MPT-2.7B: flamingo, all, the CLIP
# text tower imported from phase 17's CLIPModel, 77 tokens for the prompt
# and the neighbour texts (the text tower's position table), uncached
FAMILY7_TEXT = 77
FAMILY7_TOKENS = FAMILY7_TEXT + 128         # prompt + summary
FAMILY7_ARGV = with_flags(OPT_TRAIN_ARGV, model_name_or_path="mpt-2.7b",
                          context="all", neighbor_mode="embedding",
                          peft_type="flamingo", text_model=CKPT_CLIP,
                          visual_model=CKPT_CLIP,
                          max_input_length=FAMILY7_TEXT, **SHORT)
# BASELINE family 3 as the JAX package's bench runs it
# (scripts/bench_baseline_configs.py:36): phase 12's run under --remat
LORA_REMAT_ARGV = with_flags(LORA_ARGV, remat="true")
# OPT-6.7B + LoRA as the JAX package's scripts/probe_67b.py trains it:
# section_only, raw, LoRA r 16 alpha 32 on a frozen LM, bf16 parameters,
# remat and the chunked CE over 8 vocab chunks, 512 + 128 tokens; at
# OPT67_LAYERS of its 32 layers (full width, head dim 128) for the time limit
OPT67_TRAIN_ARGV = with_flags(OPT_TRAIN_ARGV, model_name_or_path="opt-6.7b",
                              context="section_only", peft_type="lora",
                              lora_r=16, lora_alpha=32, freeze_lm="true",
                              param_dtype="bfloat16", remat="true",
                              chunked_ce=8, **SHORT)
# the main path with the flags of phase 21: layerdrop in the test pass and
# in training; the plain CE, the profiler and wandb in one short run
OPT_LAYERDROP_TEST_ARGV = with_flags(OPT_TEST_ARGV, layerdrop=0.1)
OPT_LAYERDROP_ARGV = with_flags(OPT_TRAIN_ARGV, layerdrop=0.5, **SHORT)
OPT_PLAIN_CE_ARGV = with_flags(OPT_TRAIN_ARGV, fused_ce="false",
                               log_to_wandb="true", **SHORT)
# the device events of the port's kernels in a profiler trace: the
# bodies that mmgl_allheads_fwd_tc and mmgl_fused_heads_fwd_tc
# (allheads_fwd_kernel) and mmgl_allheads_bwd_tc (its dK/dV and dQ bodies)
# launch
TRACE_KERNELS = ("allheads_fwd_kernel", "allheads_dkdv_kernel",
                 "allheads_dq_kernel")
# the mma.sync forward body, which no entry launches since K2 moved onto
# the wgmma forward (the sweep's "before" only)
RETIRED_KERNEL = "attention_fwd_tc_kernel"
VIRTUAL = 20                # num_virtual_tokens
# the neighbour memory's projections and position tables
MEMORY = ("text_embeddings.", "visual_embeddings.",
          "text_position_embeddings.", "visual_position_embeddings.")


def flamingo_zero(name: str) -> bool:
    """MPT's parameters whose gradient is exactly 0 while the gates are 0:
    every cross-layer tensor but the gates, and the memory's projections,
    which reach the loss only through the gated cross-attention."""
    return (("neighbor_layers." in name and "gating" not in name)
            or name.startswith(MEMORY))


EMB_TEXTS = 11 * 4          # Roberta's sequences a micro-batch of 4
EMB_IMAGES = 5 * 4          # CLIP's images a micro-batch of 4
# the frozen towers' parameter prefixes
TOWERS = ("visual_model.", "text_model.")

FWD_SOURCE = "mmgl_tpu_torch/csrc/attention_fwd.cu"
BWD_SOURCE = "mmgl_tpu_torch/csrc/attention_bwd.cu"
BIAS_FWD_SOURCE = "mmgl_tpu_torch/csrc/attention_bias_fwd.cu"
BIAS_BWD_SOURCE = "mmgl_tpu_torch/csrc/attention_bias_bwd.cu"
BLOCKED_SOURCE = "mmgl_tpu_torch/csrc/attention_blocked_bwd.cu"
WGMMA_SOURCE = "mmgl_tpu_torch/csrc/allheads_wgmma.cu"
PALLAS = "mmgl_tpu/ops/flash_attention.py"
# kernel wrapper -> (its plain version, the Pallas kernel it replaces, source)
KERNELS = {
    "flash_attention_allheads": ("allheads_attention_reference",
                                 f"{PALLAS}:1283", WGMMA_SOURCE),
    "fused_heads_attention": ("fused_heads_attention_reference",
                              f"{PALLAS}:1152", FWD_SOURCE),
    "flash_attention_allheads_bwd": ("allheads_attention_bwd_reference",
                                     f"{PALLAS}:1307", WGMMA_SOURCE),
    "flash_attention": ("flash_attention_reference", f"{PALLAS}:179",
                        FWD_SOURCE),
    "flash_attention_bwd": ("flash_attention_bwd_reference", f"{PALLAS}:457",
                            BWD_SOURCE),
    "flash_attention_blocked_bwd": ("flash_attention_blocked_bwd_reference",
                                    f"{PALLAS}:336", BLOCKED_SOURCE),
    "flash_attention_bias": ("bias_attention_reference", f"{PALLAS}:768",
                             BIAS_FWD_SOURCE),
    "flash_attention_bias_bwd": ("bias_attention_bwd_reference",
                                 f"{PALLAS}:942", BIAS_BWD_SOURCE),
}
BIAS_KERNELS = ("flash_attention_bias", "flash_attention_bias_bwd")
# the tensor-core bodies the kernels line names (every timed case is bf16
# or fp16: the same bodies, m16n8k16 in .bf16 or .f16)
DESIGNS = {"wgmma_tma": "wgmma m64nNk16 (P and dS as register A operands), "
                        "TMA tiles through 4-D tensor maps into a "
                        "2-stage mbarrier ring, one producer warp and "
                        "consumer warpgroups of 64 rows; K3 from K1's "
                        "row stats; K2 K1's forward at sq == sk, K4 at "
                        "any sq and sk; K6 K3's dQ (delta fused) and "
                        "dK/dV bodies from K4's row stats, K5 the same "
                        "after K4's stats-only form, both bodies in one "
                        "grid where they fill two waves of the SMs' "
                        "slots or fewer",
           "wgmma_tma_bias": "K1's wgmma/TMA forward in its bias form: the "
                             "bias tile in the TMA ring through a 3-D map "
                             "(rows padded to 8 elements once a stack), "
                             "Philox dropout bits on P (one call a lane "
                             "per 16 keys, words swapped by a shuffle, a "
                             "keep bit an element); K8/K9's stats pass its "
                             "stats-only form",
           "bias_tc": "K3's wgmma/TMA dQ (delta fused) and dK/dV bodies "
                      "in their bias form, in K3's shapes: each streamed "
                      "tile's bias in the TMA ring through K7's 3-D map "
                      "(read transposed in dK/dV), Philox dropout bits "
                      "regenerated in both (words swapped with lane ^ 2 in "
                      "dQ, lane ^ 16 in dK/dV), from K7's row stats; both "
                      "bodies' blocks in one grid where they fill two "
                      "waves of the SMs' slots or fewer (dK/dV making its "
                      "own delta), else dQ then dK/dV; dQ writes the fp32 "
                      "dlogits (zeros on skipped tiles) into a partial "
                      "reduced over the batch in order; no delta pass, no "
                      "mask tensor for none"}
OPT_TEST_KERNELS = ("flash_attention_allheads", "fused_heads_attention")
OPT_TRAIN_KERNELS = OPT_TEST_KERNELS + ("flash_attention_allheads_bwd",)
# the OPT attention calls: (kernel, (B, S, H, D), causal, mask)
CASES = [
    ("flash_attention_allheads", (4, 640, 12, 64), True, "hole"),   # eval
    ("flash_attention_allheads", (4, 512, 12, 64), True, "prompt"),  # prefill
    ("fused_heads_attention", (24, 197, 12, 64), False, "ones"),    # CLIP
    ("flash_attention_allheads", (4, 640, 12, 64), False, "fully_masked"),
    ("fused_heads_attention", (24, 197, 12, 64), False, "fully_masked"),
    # Roberta over 11 neighbor texts x 4 samples, each right-padded, an
    # empty slot fully masked
    ("flash_attention_allheads", (44, 512, 12, 64), False, "texts"),
    # OPT-1.3B + LoRA: 640 + 44 tokens, 32 heads, and the 556-token prefill
    ("flash_attention_allheads", (4, 684, 32, 64), True, "hole"),
    ("flash_attention_allheads", (4, 556, 32, 64), True, "prompt"),
    # prompt tuning: 20 virtual tokens in front of 704, and the prefill's
    # 20 + 576
    ("flash_attention_allheads", (4, 724, 12, 64), True, "prefix"),
    ("flash_attention_allheads", (4, 596, 12, 64), True, "prompt"),
    # the CLIP text tower over 11 neighbour texts x 4 samples at 77 tokens
    # (8 heads, S padded to 128 in K2), causal: right-padded texts with an
    # empty one, and a pad hole with a fully masked text
    ("fused_heads_attention", (44, 77, 8, 64), True, "texts"),
    ("fused_heads_attention", (44, 77, 8, 64), True, "gap_fully_masked"),
]
ROBERTA_CASE = 5
CLIP_TEXT_CASE = 10
# phase 3's worst errors and phase 8's rows of these cases under their own
# name in the kernels line
CASE_TAGS = {10: "[clip-text]", 11: "[clip-text]"}
# K3 (the training step's attention backward): ((B, S, H, D), causal, mask);
# the training shape, the same with a fully masked sample, and a ragged
# length whose tiles the bounds checks cut
BWD_CASES = [((4, 640, 12, 64), True, "hole"),
             ((4, 640, 12, 64), True, "hole_fully_masked"),
             ((3, 333, 2, 64), True, "hole333"),
             # OPT-1.3B + LoRA's 684 tokens; prompt tuning's 724
             ((4, 684, 32, 64), True, "hole"),
             ((4, 724, 12, 64), True, "prefix")]
# K4/K5: ((B, Sq, Sk, H, K/V heads), causal, key mask): T5-base's eval
# cross-attention over the padded encoder input, MQA, ragged lengths
FLASH_CASES = [((4, 128, 512, 12, 12), False, "gap"),
               ((4, 128, 128, 12, 1), False, "gap"),
               ((3, 333, 77, 2, 2), False, "gap_fully_masked"),
               # MPT-1.3B's cross-attention: 640 queries against the 64-token
               # memory (sq > sk), sample 0 without neighbours
               ((4, 640, 64, 32, 32), False, "gap_fully_masked"),
               # prefix tuning: 704 queries against 20 + 704 keys, causal
               ((4, 704, 724, 12, 12), True, "prefix"),
               # MPT-1.3B's prefill: 512 queries against the memory
               ((4, 512, 64, 32, 32), False, "gap_fully_masked")]
# the kernels line's own entries for these shapes, by FLASH_CASES index
FLASH_TAGS = {3: "[mpt-cross]", 4: "[prefix]"}
MPT_CROSS_CASE, PREFIX_CASE = 3, 4
# K4 with its row stats and K6: ((B, Sq, Sk, H), causal, key mask):
# OPT-350M's training shape (prompt 1920 + summary 128, a pad hole in each),
# the same with a fully masked sample, ragged, end-aligned sq < sk
BLOCKED_CASES = [((4, 2048, 2048, 16), True, "hole"),
                 ((4, 2048, 2048, 16), True, "hole_fully_masked"),
                 ((3, 333, 333, 2), True, "hole333"),
                 ((2, 200, 328, 2), True, "gap")]
# K1 and K3-K6 at head dims 80 and 128: (name, (B, Sq, Sk, H, D), causal,
# key mask): OPT-2.7B's training shape, causal with a pad hole; MPT-2.7B's
# cross-attention, 640 queries against the 64-token memory, sample 0
# without neighbours; OPT-6.7B's training shape; the 512-token prefills of
# MPT-2.7B (self- and cross-attention) and OPT-6.7B, right-padded prompts;
# a ragged 333 at each D; BASELINE family 7's (phase 18) training step, 77 +
# 128 tokens causal with a pad hole and against the 64-token memory, and its
# 77-token prefill
HEAD_DIM_CASES = [("opt-2.7b", (4, 640, 640, 32, 80), True, "hole"),
                  ("mpt-2.7b cross", (4, 640, 64, 32, 80), False,
                   "gap_fully_masked"),
                  ("opt-6.7b", (4, 640, 640, 32, 128), True, "hole"),
                  ("mpt-2.7b prefill", (4, 512, 512, 32, 80), True,
                   "prompt"),
                  ("mpt-2.7b prefill cross", (4, 512, 64, 32, 80), False,
                   "gap_fully_masked"),
                  ("opt-6.7b prefill", (4, 512, 512, 32, 128), True,
                   "prompt"),
                  ("ragged", (3, 333, 333, 2, 80), True, "hole333"),
                  ("ragged", (3, 333, 333, 2, 128), True, "hole333"),
                  ("family 7", (4, FAMILY7_TOKENS, FAMILY7_TOKENS, 32, 80),
                   True, "hole"),
                  ("family 7 cross", (4, FAMILY7_TOKENS, 64, 32, 80), False,
                   "gap_fully_masked"),
                  ("family 7 prefill", (4, FAMILY7_TEXT, FAMILY7_TEXT, 32,
                                        80), True, "prompt"),
                  ("family 7 prefill cross", (4, FAMILY7_TEXT, 64, 32, 80),
                   False, "gap_fully_masked")]
# K7/K8/K9: (name, (B, Sq, Sk, H), causal, bias): T5-base's encoder, decoder
# self- and training cross-attention, ragged lengths; each without and with
# dropout 0.1, T5's scale 1.0
BIAS_CASES = [("enc", (4, 512, 512, 12), False, True),
              ("dec", (4, 128, 128, 12), True, True),
              ("cross", (4, 128, 512, 12), False, False),
              ("ragged", (3, 333, 333, 2), True, True),
              # the embedding mode's encoder: 512 + 16 x 4 soft tokens,
              # nine key tiles
              ("enc576", (4, 576, 576, 12), False, True),
              # T5's prefixed decoder: 128 queries against 20 + 128 keys,
              # the bias padded by 20 zero columns (a row of 148, padded to
              # 152 for the tensor-core body), the last key tile 20 wide
              ("t5prefix", (4, 128, 148, 12), True, True)]
ENC576_CASE = 4
T5_PREFIX_CASE = 5
BIAS_TAGS = {T5_PREFIX_CASE: "[t5-prefix]"}
RATE = 0.1
# (atol, rtol) by dtype name; float16 keeps 11 significant bits to bf16's 8,
# and its tensor-core form rounds where the bf16 form does
TOLERANCES = {"bfloat16": (2e-2, 2e-2), "float16": (5e-3, 5e-3),
              "float32": (2e-5, 0.0)}
# backward, per gradient: (atol as a fraction of its largest entry, rtol);
# bf16 and fp16: P (times the keep factor) and dS rounded to the input type
# before their products from logits summed in another order, in the
# tensor-core bodies and the plain versions alike
BWD_TOLERANCES = {"bfloat16": (2e-2, 2e-2), "float16": (5e-3, 5e-3),
                  "float32": (1e-5, 0.0)}
TC_DTYPES = ("bfloat16", "float16")
# K4's row max and sum, (atol, rtol) in either dtype: fp32 sums of up to
# 2048 exponentials in another order
STATS_TOLERANCES = (1e-4, 1e-4)
# whole-model fp32 check, card vs CPU: logits and loss
MODEL_ATOL = 1e-3
# fp32 training micro-step, card vs CPU: (loss atol, gradient-norm rtol,
# largest gradient error as a fraction of the largest gradient); sums over
# hundreds of tokens through 12 layers in another order; a wrong kernel is
# off by the gradient's own size. T5's random-init gradient moves more
# under reordered sums: its plain versions on the card differ from the CPU
# by 1.1e-2 of a largest gradient of 2.3 and by 8e-4 in norm (on an H100
# 80GB HBM3 at 700 W), so its bound is wider, and its kernels are also held
# to twice the plain versions' own error on the card
STEP_TOL = (1e-3, 1e-4, 1e-3)
T5_STEP_TOL = (1e-3, 5e-3, 1e-2)
# phase 8: calls back to back in one timed sample; the plain versions,
# whose calls take 0.2-17 ms, need no run to hide the host's launches,
# and ten calls a sample of them took a minute of the time limit
TIMING_RUN = 10
PLAIN_RUN = 2
# H100 SXM data-sheet peaks (dense bf16, HBM3)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def wkey(name: str, dtype_name: str) -> str:
    """A kernel's key in the worst-error table and the kernels line: its
    float16 form apart."""
    return name + "[fp16]" if dtype_name == "float16" else name


def make_mask(kind: str, b: int, s: int, seed: int):
    """(B, S) int32 key mask. "hole": a decoder-only batch, prompt padded to
    S - 128 then summary padded to 128, so the valid keys have a hole
    ("hole333": the same at S = 333, prompt 250); "prompt": right-padded
    prompts (each keeps at least 100 tokens, or half of a shorter S); "gap": a pad hole in the middle and right padding, any S;
    "fully_masked": sample 0 all zero (with holes in the others for
    "hole_fully_masked" and "gap_fully_masked"); "texts": neighbor texts,
    each right-padded to a random length, sample 0 all zero (an empty
    neighbor slot); "prefix": 20 virtual keys, always valid, then a
    decoder-only batch's "hole" keys; "rows_masked": sample 0 with a
    "gap" (where S > 2), sample 1 its first third masked (its first causal
    rows see no valid key), sample 2 all masked."""
    import numpy as np

    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    if kind == "hole":
        cut = s - 128
        for i in range(b):
            mask[i, rng.randint(min(100, cut // 2), cut):cut] = 0
            mask[i, cut + rng.randint(20, 128):] = 0
    elif kind == "prompt":
        for i in range(b):
            mask[i, rng.randint(min(100, s // 2), s):] = 0
    elif kind == "hole333":
        for i in range(b):
            mask[i, rng.randint(50, 250):250] = 0
            mask[i, 250 + rng.randint(1, 83):] = 0
    elif kind == "gap":
        for i in range(b):
            mask[i, rng.randint(s // 5, s // 2):s // 2] = 0
            mask[i, s - rng.randint(1, max(2, s // 8)):] = 0
    elif kind in ("hole_fully_masked", "gap_fully_masked"):
        mask = make_mask(kind.split("_")[0], b, s, seed)
        mask[0] = 0
    elif kind == "fully_masked":
        mask[0] = 0
    elif kind == "texts":
        for i in range(b):
            mask[i, rng.randint(1, s + 1):] = 0
        mask[0] = 0
    elif kind == "prefix":
        mask[:, VIRTUAL:] = make_mask("hole", b, s - VIRTUAL, seed)
    elif kind == "rows_masked":
        if s > 2:
            mask[0] = make_mask("gap", 1, s, seed)[0]
        mask[1, :max(1, s // 3)] = 0
        mask[2:] = 0
    return mask


def kernel_inputs(case_index: int, dtype, device):
    import torch

    _, shape, causal, mask_kind = CASES[case_index]
    g = torch.Generator().manual_seed(case_index)
    q, k, v = (torch.randn(shape, generator=g).to(device=device, dtype=dtype)
               for _ in range(3))
    mask = torch.from_numpy(make_mask(mask_kind, shape[0], shape[1],
                                      case_index)).to(device)
    return (q, k, v), dict(kv_mask=mask, causal=causal)


def bwd_inputs(case_index: int, dtype, device):
    """K3's inputs: q, k, v, the mask, the forward output (plain version)
    and a random cotangent."""
    import torch
    from mmgl_tpu_torch.ops import flash_attention as fa

    shape, causal, mask_kind = BWD_CASES[case_index]
    g = torch.Generator().manual_seed(100 + case_index)
    q, k, v, dout = (torch.randn(shape, generator=g).to(device=device,
                                                         dtype=dtype)
                     for _ in range(4))
    mask = torch.from_numpy(make_mask(mask_kind, shape[0], shape[1],
                                      case_index)).to(device)
    out = fa.allheads_attention_reference(q, k, v, kv_mask=mask,
                                          causal=causal)
    return (q, k, v, mask, out, dout), dict(causal=causal)


def reset_launches(fa) -> None:
    """Every wrapper's launch counts to 0."""
    for name in KERNELS:
        getattr(fa, name).launches = 0
        getattr(fa, name).launches_tc = 0


def check_bodies(fa, tag: str, bf16: bool):
    """Every kernel launch since the counts were reset took the
    tensor-core body (``bf16`` true: bf16 or fp16 compute) or none did
    (fp32); returns {name: (launches, tensor-core launches)}."""
    counts = {n: (getattr(fa, n).launches, getattr(fa, n).launches_tc)
              for n in KERNELS}
    print(f"[{tag}] K1-K9 launches (all, tensor-core body): {counts}")
    wrong = {n: c for n, c in counts.items() if c[1] != (c[0] if bf16 else 0)}
    if wrong:
        fail(f"{tag}: kernel launches took the "
             f"{'scalar' if bf16 else 'tensor-core'} body: {wrong}")
    return counts


def _within(got, ref, atol, rtol) -> bool:
    import torch

    err = (got.float() - ref.float()).abs()
    return (got.dtype == ref.dtype and got.shape == ref.shape
            and bool(torch.isfinite(got).all())
            and bool((err <= atol + rtol * ref.float().abs()).all()))


def _grads_within(name, got, ref, dtype_name, label, worst):
    """Each gradient against its plain version at the backward tolerance;
    records the worst error under ``name``; returns the report."""
    atol, rtol = BWD_TOLERANCES[dtype_name]
    report = []
    for grad, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            continue
        max_err = float((g.float() - r.float()).abs().max())
        ok = _within(g, r, atol * float(r.float().abs().max()), rtol)
        report.append(f"{grad} {max_err:.3e}{'' if ok else ' FAIL'}")
        key = wkey(name, dtype_name)
        worst[key] = max(worst[key], max_err)
        if not ok:
            print(f"[check] {name} {label} {dtype_name}: {', '.join(report)}")
            fail(f"{name} {grad} disagrees with its plain version")
    return ", ".join(report)


def check_opt_kernels(fa, device, worst):
    """Phase 3, K1-K3: each case in each dtype; K2 at CLIP's 197 patches
    also without a mask, as the vision tower calls it (a null pointer to
    the wgmma body)."""
    import torch

    for i, (name, shape, causal, mask_kind) in enumerate(CASES):
        kernel = getattr(fa, name)
        plain = getattr(fa, KERNELS[name][0])
        for dtype_name, (atol, rtol) in TOLERANCES.items():
            args, kw = kernel_inputs(i, getattr(torch, dtype_name), device)
            kws = [kw]
            if name == "fused_heads_attention" and mask_kind == "ones":
                kws.append(dict(kw, kv_mask=None))
            for kw in kws:
                got = kernel(*args, **kw)
                torch.cuda.synchronize(device)
                ref = plain(*args, **kw)
                max_err = float((got.float() - ref.float()).abs().max())
                ok = _within(got, ref, atol, rtol)
                what = "none" if kw["kv_mask"] is None else mask_kind
                print(f"[check] {name} {shape} causal={causal} mask={what} "
                      f"{dtype_name}: max_abs_err={max_err:.3e} "
                      f"atol={atol:g} rtol={rtol:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{name} disagrees with its plain version")
                key = wkey(name + CASE_TAGS.get(i, ""), dtype_name)
                worst[key] = max(worst[key], max_err)
    name = "flash_attention_allheads_bwd"
    for i, (shape, causal, mask_kind) in enumerate(BWD_CASES):
        for dtype_name in BWD_TOLERANCES:
            args, kw = bwd_inputs(i, getattr(torch, dtype_name), device)
            got = fa.flash_attention_allheads_bwd(*args, **kw)
            torch.cuda.synchronize(device)
            ref = fa.allheads_attention_bwd_reference(*args, **kw)
            label = f"{shape} causal={causal} mask={mask_kind}"
            report = _grads_within(name, got, ref, dtype_name, label, worst)
            print(f"[check] {name} {label} {dtype_name}: max_abs_err "
                  f"{report} ok")


def flash_inputs(dims, mask_kind, dtype, device, seed, d=64):
    """q, k, v (k/v with kv_heads heads), the key mask, a cotangent; head
    dim d."""
    import torch

    b, sq, sk, h, kvh = dims
    g = torch.Generator().manual_seed(seed)
    q, dout = (torch.randn(b, sq, h, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, sk, kvh, d, generator=g) for _ in range(2))
    mask = torch.from_numpy(make_mask(mask_kind, b, sk, seed)).to(device)
    q, k, v, dout = (t.to(device, dtype) for t in (q, k, v, dout))
    return q, k, v, mask, dout


def bias_inputs(dims, with_bias, dtype, device, seed):
    """q (T5's scale folded in: x 1/8), k, v, a key mask with a pad hole and
    a fully masked sample, the (1, H, Sq, Sk) bias or None, a cotangent, and
    a dropout key."""
    import torch

    b, sq, sk, h = dims
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, h, 64, generator=g) * 0.125
    k, v = (torch.randn(b, sk, h, 64, generator=g) for _ in range(2))
    dout = torch.randn(b, sq, h, 64, generator=g)
    bias = (torch.randn(1, h, sq, sk, generator=g) if with_bias else None)
    mask = torch.from_numpy(make_mask("gap_fully_masked", b, sk,
                                      seed)).to(device)
    seed_t = torch.tensor([seed * 7919 + 1, 2 ** 32 - seed - 1],
                          dtype=torch.int64, device=device)
    q, k, v, dout = (t.to(device, dtype) for t in (q, k, v, dout))
    if bias is not None:
        bias = bias.to(device, dtype)
    return q, k, v, mask, bias, dout, seed_t


def check_t5_kernels(fa, device, worst):
    """Phase 3, K4/K5 and K7/K8/K9: forward and gradients (through autograd,
    so the backward kernels run as training runs them) against the plain
    versions; the dropout mask bit for bit."""
    import torch

    for i, (dims, causal, mask_kind) in enumerate(FLASH_CASES):
        b, sq, sk, h, kvh = dims
        for dtype_name, (atol, rtol) in TOLERANCES.items():
            q, k, v, mask, dout = flash_inputs(
                dims, mask_kind, getattr(torch, dtype_name), device, 200 + i)
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            got = fa.flash_attention(q, k, v, kv_mask=mask, causal=causal)
            grads = torch.autograd.grad(got, (q, k, v), dout)
            torch.cuda.synchronize(device)
            kx, vx = (t.detach().expand(b, sk, h, 64).contiguous()
                      for t in (k, v))
            ref = fa.flash_attention_reference(q.detach(), kx, vx,
                                               kv_mask=mask, causal=causal)
            max_err = float((got.detach().float() - ref.float()).abs().max())
            tag = FLASH_TAGS.get(i, "")
            for key in {wkey("flash_attention", dtype_name),
                        wkey("flash_attention" + tag, dtype_name)}:
                worst[key] = max(worst[key], max_err)
            if not _within(got.detach(), ref, atol, rtol):
                fail(f"flash_attention {dims} {dtype_name} disagrees with "
                     f"its plain version ({max_err:.3e})")
            refs = list(fa.flash_attention_bwd_reference(
                q.detach(), kx, vx, mask, got.detach(), dout, causal=causal))
            if kvh == 1:   # expand's gradient: the sum over the heads
                refs[1:] = [r.float().sum(2, keepdim=True).to(r.dtype)
                            for r in refs[1:]]
            label = f"{dims} causal={causal} mask={mask_kind}"
            report = _grads_within("flash_attention_bwd" + tag, grads, refs,
                                   dtype_name, label, worst)
            base = wkey("flash_attention_bwd", dtype_name)
            worst[base] = max(worst[base], worst[
                wkey("flash_attention_bwd" + tag, dtype_name)])
            print(f"[check] flash_attention {label} {dtype_name}: forward "
                  f"{max_err:.3e} ok; flash_attention_bwd {report} ok")

    for i, (tag, dims, causal, with_bias) in enumerate(BIAS_CASES):
        for rate in (0.0, RATE):
            for dtype_name, (atol, rtol) in TOLERANCES.items():
                q, k, v, mask, bias, dout, seed = bias_inputs(
                    dims, with_bias, getattr(torch, dtype_name), device,
                    300 + i)
                wrt = [q, k, v] + ([bias] if with_bias else [])
                for t in wrt:
                    t.requires_grad_()
                got = fa.flash_attention_bias(
                    q, k, v, bias=bias, kv_mask=mask, causal=causal,
                    scale=1.0, dropout_rate=rate, dropout_seed=seed)
                grads = list(torch.autograd.grad(got, wrt, dout))
                torch.cuda.synchronize(device)
                plain_bias = None if bias is None else bias.detach()
                ref = fa.bias_attention_reference(
                    q.detach(), k.detach(), v.detach(), bias=plain_bias,
                    kv_mask=mask, causal=causal, scale=1.0,
                    dropout_rate=rate, dropout_seed=seed)
                max_err = float((got.detach().float()
                                 - ref.float()).abs().max())
                tag = BIAS_TAGS.get(i, "")
                for key in {wkey("flash_attention_bias", dtype_name),
                            wkey("flash_attention_bias" + tag, dtype_name)}:
                    worst[key] = max(worst[key], max_err)
                if not _within(got.detach(), ref, atol, rtol):
                    fail(f"flash_attention_bias {tag} {dims} rate={rate} "
                         f"{dtype_name} disagrees with its plain version "
                         f"({max_err:.3e})")
                refs = fa.bias_attention_bwd_reference(
                    q.detach(), k.detach(), v.detach(), mask, plain_bias,
                    got.detach(), dout, causal=causal, scale=1.0,
                    dropout_rate=rate, dropout_seed=seed)
                label = (f"{tag} {dims} causal={causal} bias={with_bias} "
                         f"dropout={rate}")
                report = _grads_within("flash_attention_bias_bwd" + tag,
                                       grads, refs, dtype_name, label, worst)
                base = wkey("flash_attention_bias_bwd", dtype_name)
                worst[base] = max(worst[base], worst[
                    wkey("flash_attention_bias_bwd" + tag, dtype_name)])
                print(f"[check] flash_attention_bias {label} {dtype_name}: "
                      f"forward {max_err:.3e} ok; flash_attention_bias_bwd "
                      f"{report} ok")
    keep = {}
    for tag, dims, _, _ in BIAS_CASES:
        for dtype_name in TOLERANCES:
            keep[f"{tag} {dtype_name}"] = check_dropout_mask(
                fa, dims, device, getattr(torch, dtype_name))
    for dtype_name in TC_DTYPES:
        check_bias_stats_path(fa, device, worst, dtype_name)
    return keep


def check_bias_stats_path(fa, device, worst, dtype_name):
    """Phase 3, at the encoder's shape with dropout, bf16 or fp16: K7's row
    stats against the plain version's, and K8/K9 from them (as training runs
    it) equal to K8/K9 with its own stats pass, bit for bit: the stats-only
    pass computes K7's max and sum with K7's instructions."""
    import torch

    tag, dims, causal, with_bias = BIAS_CASES[0]
    q, k, v, mask, bias, dout, seed = bias_inputs(
        dims, with_bias, getattr(torch, dtype_name), device, 300)
    kw = dict(kv_mask=mask, causal=causal, scale=1.0, dropout_rate=RATE,
              dropout_seed=seed)
    out, m, l = fa.flash_attention_bias_stats(q, k, v, bias=bias, **kw)
    torch.cuda.synchronize(device)
    ref = fa.bias_attention_reference(q, k, v, bias=bias, with_stats=True,
                                      **kw)
    errs = [float((g.float() - r.float()).abs().max())
            for g, r in zip((out, m, l), ref)]
    key = wkey("flash_attention_bias", dtype_name)
    worst[key] = max(worst[key], errs[0])
    label = f"{tag} {dims} bias dropout={RATE} {dtype_name}"
    if not (_within(out, ref[0], *TOLERANCES[dtype_name])
            and _within(m, ref[1], *STATS_TOLERANCES)
            and _within(l, ref[2], *STATS_TOLERANCES)):
        fail(f"flash_attention_bias_stats {label} disagrees with its plain "
             f"version (out {errs[0]:.3e}, max {errs[1]:.3e}, sum "
             f"{errs[2]:.3e})")
    bkw = dict(causal=causal, scale=1.0, dropout_rate=RATE,
               dropout_seed=seed)
    saved = fa.flash_attention_bias_bwd(q, k, v, mask, bias[0], out, dout,
                                        row_max=m, row_sum=l, **bkw)
    own = fa.flash_attention_bias_bwd(q, k, v, mask, bias[0], out, dout,
                                      **bkw)
    torch.cuda.synchronize(device)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), saved, own):
        if not torch.equal(g, r):
            fail(f"K8/K9 from K7's stats differs from K8/K9 with its stats "
                 f"pass in {name} at {label} (max abs "
                 f"{float((g.float() - r.float()).abs().max()):.3e})")
    print(f"[check] flash_attention_bias_stats {label}: out {errs[0]:.3e}, "
          f"max {errs[1]:.3e}, sum {errs[2]:.3e} ok; flash_attention_bias_bwd"
          f" from them equal to its own stats pass bit for bit")


def blocked_inputs(case_index: int, dtype, device):
    """K4/K6's inputs at BLOCKED_CASES[i]: q, k, v, the key mask, a
    cotangent."""
    (b, sq, sk, h), _, mask_kind = BLOCKED_CASES[case_index]
    return flash_inputs((b, sq, sk, h, h), mask_kind, dtype, device,
                        400 + case_index)


def k6_against_k3_and_k5(fa, q, k, v, mask, out, dout, m, l, got, k5,
                         dtype_name, label):
    """K6's gradients ``got`` from K4's row stats ``m``, ``l`` against K5's
    ``k5`` on the same inputs, which computes the same gradient with a
    stats pass (K4's body in its stats-only form, the same bits): bit for
    bit in every dtype (fp32 the same scalar tiles, bf16 and fp16 K3's
    wgmma bodies, one grid or two launches); and, in bf16 and fp16 where
    K3 takes the inputs (sq <= sk), K4's stats equal to K1's and K6 equal
    to K3 given them (the same bodies), bit for bit. Returns the report."""
    import torch

    errs = []
    for name, g, r in zip(("dq", "dk", "dv"), got, k5):
        errs.append(float((g.float() - r.float()).abs().max()))
        if not torch.equal(g, r):
            fail(f"K6's {name} differs from K5's at {label} "
                 f"{dtype_name} (max abs {errs[-1]:.3e})")
    report = ("against flash_attention_bwd (K5): equal bit for bit (max "
              f"abs {', '.join(f'{e:g}' for e in errs)})")
    if dtype_name == "float32" or q.shape[1] > k.shape[1]:
        return report
    _, m1, l1 = fa.flash_attention_allheads_stats(q, k, v, kv_mask=mask,
                                                  causal=True)
    k3 = fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                         causal=True, row_max=m, row_sum=l)
    torch.cuda.synchronize(q.device)
    if not (torch.equal(m1, m) and torch.equal(l1, l)):
        fail(f"K4's row stats differ from K1's at {label} {dtype_name}")
    for name, g, r in zip(("dq", "dk", "dv"), got, k3):
        if not torch.equal(g, r):
            fail(f"K6's {name} differs from K3's given the same stats at "
                 f"{label} {dtype_name} (max abs "
                 f"{float((g.float() - r.float()).abs().max()):.3e})")
    return (report + "; K4's stats = K1's and K6 = K3 from them, bit for "
            "bit")


def check_blocked_kernels(fa, device, worst):
    """Phase 3, K4 with its row stats and K6: the output and stats against
    the plain version's, K6 (from the kernel's output and stats) against
    its plain version on the same inputs, and at OPT-350M's shape K6
    against K3 and K5 (``k6_against_k3_and_k5``)."""
    import torch

    for i, (dims, causal, mask_kind) in enumerate(BLOCKED_CASES):
        label = f"{dims} causal={causal} mask={mask_kind}"
        for dtype_name, (atol, rtol) in TOLERANCES.items():
            q, k, v, mask, dout = blocked_inputs(i, getattr(torch, dtype_name),
                                                 device)
            out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask,
                                                 causal=causal)
            torch.cuda.synchronize(device)
            ref = fa.flash_attention_reference(q, k, v, kv_mask=mask,
                                               causal=causal, with_stats=True)
            max_err = float((out.float() - ref[0].float()).abs().max())
            s_atol, s_rtol = STATS_TOLERANCES
            stats_err = [float((g - r).abs().max())
                         for g, r in zip((m, l), ref[1:])]
            key = wkey("flash_attention[stats]", dtype_name)
            worst[key] = max(worst[key], max_err, *stats_err)
            if not (_within(out, ref[0], atol, rtol)
                    and _within(m, ref[1], s_atol, s_rtol)
                    and _within(l, ref[2], s_atol, s_rtol)):
                fail(f"flash_attention_stats {label} {dtype_name} disagrees "
                     f"with its plain version (out {max_err:.3e}, max "
                     f"{stats_err[0]:.3e}, sum {stats_err[1]:.3e})")
            del ref
            got = fa.flash_attention_blocked_bwd(q, k, v, mask, out, dout, m,
                                                 l, causal=causal)
            torch.cuda.synchronize(device)
            refs = fa.flash_attention_blocked_bwd_reference(
                q, k, v, mask, out, dout, m, l, causal=causal)
            report = _grads_within("flash_attention_blocked_bwd", got, refs,
                                   dtype_name, label, worst)
            line = (f"[check] flash_attention_stats {label} {dtype_name}: "
                    f"out {max_err:.3e}, max {stats_err[0]:.3e}, sum "
                    f"{stats_err[1]:.3e} ok; flash_attention_blocked_bwd "
                    f"{report} ok")
            del refs
            if i == 0:
                k5 = fa.flash_attention_bwd(q, k, v, mask, out, dout,
                                            causal=causal)
                torch.cuda.synchronize(device)
                line += "; " + k6_against_k3_and_k5(
                    fa, q, k, v, mask, out, dout, m, l, got, k5, dtype_name,
                    label)
                del k5
            print(line)
            del q, k, v, mask, dout, out, m, l, got
    torch.cuda.empty_cache()


# K1's and K3's wgmma bodies at the lengths that cut their TMA boxes (64
# rows) and tiles (64 and 128 rows), family 7's 205 and OPT's 640, and one
# Sq < Sk with the ends aligned: (Sq, Sk)
WGMMA_LENGTHS = [(s, s) for s in (1, 63, 64, 65, 127, 128, 129, 205, 640)] + [
    (100, 228)]


def check_wgmma_kernels(fa, device, worst):
    """Phase 3, K1 and K3 on their wgmma bodies: at each (Sq, Sk) of
    WGMMA_LENGTHS, head dims 64, 80 and 128, bf16 and fp16, causal, with a
    pad gap, fully masked rows and a fully masked sample ("rows_masked"):
    K1 against its plain version at phase 3's tolerance, its row max and
    sum within 1e-5 and 1e-4 of ``_row_stats``, K3 against its plain
    version at the backward tolerance (an atol of at least 1e-3 times it:
    at S = 1 dQ and dK are 0, the residue of dP - delta on both sides), and
    K3 from K1's stats equal to K3 with its own stats pass, bit for bit."""
    import torch

    for d in (64, 80, 128):
        for sq, sk in WGMMA_LENGTHS:
            for dtype_name in ("bfloat16", "float16"):
                atol, rtol = TOLERANCES[dtype_name]
                q, k, v, mask, dout = flash_inputs(
                    (3, sq, sk, 2, 2), "rows_masked",
                    getattr(torch, dtype_name), device, 700 + sq + d, d)
                label = f"(3, {sq}, {sk}, 2, {d}) causal {dtype_name}"
                out, m, l = fa.flash_attention_allheads_stats(
                    q, k, v, kv_mask=mask, causal=True)
                own = fa.flash_attention_allheads_bwd(q, k, v, mask, out,
                                                      dout, causal=True)
                given = fa.flash_attention_allheads_bwd(
                    q, k, v, mask, out, dout, causal=True, row_max=m,
                    row_sum=l)
                torch.cuda.synchronize(device)
                ref = fa.allheads_attention_reference(q, k, v, kv_mask=mask,
                                                      causal=True)
                err = float((out.float() - ref.float()).abs().max())
                key = wkey(dkey("flash_attention_allheads", d), dtype_name)
                worst[key] = max(worst[key], err)
                want_m, want_l = fa._row_stats(q, k, mask, True, d ** -0.5)
                if not (_within(out, ref, atol, rtol)
                        and _within(m, want_m, 1e-5, 1e-5)
                        and _within(l, want_l, 0.0, 1e-4)):
                    fail(f"K1's wgmma body {label}: out {err:.3e} from its "
                         "plain version, or its row stats off")
                if not all(torch.equal(a, b) for a, b in zip(own, given)):
                    fail(f"K3 {label} from K1's stats differs from K3 with "
                         "its own stats pass")
                ref_g = fa.allheads_attention_bwd_reference(
                    q, k, v, mask, out, dout, causal=True)
                gtol = BWD_TOLERANCES[dtype_name][0]
                for grad, g, r in zip(("dq", "dk", "dv"), own, ref_g):
                    e = float((g.float() - r.float()).abs().max())
                    key = wkey(dkey("flash_attention_allheads_bwd", d),
                               dtype_name)
                    worst[key] = max(worst[key], e)
                    scale = max(float(r.float().abs().max()), 1e-3)
                    if not _within(g, r, gtol * scale,
                                   BWD_TOLERANCES[dtype_name][1]):
                        fail(f"K3's wgmma bodies {label}: {grad} {e:.3e} "
                             "from its plain version")
        print(f"[check] K1, K3 wgmma bodies at head dim {d}, (Sq, Sk) "
              f"{WGMMA_LENGTHS}, causal, bf16 and fp16, rows_masked: ok; "
              "K3 from K1's stats = K3 with its own, bit for bit")


# K4's wgmma body at its query lengths (T5's 128, family 7's 205, MPT's
# 640, OPT-350M's 2048, and the 64-row TMA box's edges) against its key
# lengths (MPT's 64-token memory, T5's prefixed 148, its 512 encoder keys,
# prefix tuning's 724)
K4_LENGTHS = (63, 64, 65, 128, 205, 640, 2048)
K4_KEYS = (64, 148, 512, 724)


def check_k4_wgmma(fa, device, worst):
    """Phase 3, K4 on its wgmma body: at each (Sq, Sk) of K4_LENGTHS x
    K4_KEYS, head dims 64, 80 and 128, bf16 and fp16, (2, Sq, Sk, 2),
    sample 0 fully masked and sample 1 with a pad gap: not causal without
    a mask (a null pointer) and with it, against the plain version at phase
    3's tolerance; where Sq <= Sk causal with its row stats (within
    STATS_TOLERANCES of the plain version's), K6 from them against its
    plain version and against K3 and K5 (``k6_against_k3_and_k5``)."""
    import torch

    for d in (64, 80, 128):
        for dtype_name in TC_DTYPES:
            atol, rtol = TOLERANCES[dtype_name]
            for sq in K4_LENGTHS:
                for sk in K4_KEYS:
                    q, k, v, mask, dout = flash_inputs(
                        (2, sq, sk, 2, 2), "gap_fully_masked",
                        getattr(torch, dtype_name), device, 900 + sq + sk,
                        d)
                    label = f"(2, {sq}, {sk}, 2, {d}) {dtype_name}"
                    key = wkey(dkey("flash_attention", d), dtype_name)
                    for kv_mask in (None, mask):
                        out = fa.flash_attention(q, k, v, kv_mask=kv_mask)
                        ref = fa.flash_attention_reference(q, k, v,
                                                           kv_mask=kv_mask)
                        err = float((out.float() - ref.float()).abs().max())
                        worst[key] = max(worst[key], err)
                        if not _within(out, ref, atol, rtol):
                            fail(f"K4's wgmma body {label}: {err:.3e} from "
                                 "its plain version")
                    if sq > sk:
                        continue
                    out, m, l = fa.flash_attention_stats(
                        q, k, v, kv_mask=mask, causal=True)
                    ref = fa.flash_attention_reference(
                        q, k, v, kv_mask=mask, causal=True, with_stats=True)
                    if not (_within(out, ref[0], atol, rtol)
                            and _within(m, ref[1], *STATS_TOLERANCES)
                            and _within(l, ref[2], *STATS_TOLERANCES)):
                        fail(f"K4's wgmma body with stats {label} causal "
                             "disagrees with its plain version")
                    k6 = fa.flash_attention_blocked_bwd(
                        q, k, v, mask, out, dout, m, l, causal=True)
                    k5 = fa.flash_attention_bwd(q, k, v, mask, out, dout,
                                                causal=True)
                    torch.cuda.synchronize(device)
                    _grads_within(
                        "flash_attention_blocked_bwd", k6,
                        fa.flash_attention_blocked_bwd_reference(
                            q, k, v, mask, out, dout, m, l, causal=True),
                        dtype_name, label, worst)
                    k6_against_k3_and_k5(fa, q, k, v, mask, out, dout, m, l,
                                         k6, k5, dtype_name, label)
        print(f"[check] K4 wgmma body at head dim {d}, Sq {K4_LENGTHS} x Sk "
              f"{K4_KEYS}, bf16 and fp16, no mask and a pad gap with a "
              "fully masked sample: ok; causal with stats where Sq <= Sk: "
              "ok, K6 = K5 and = K3 from K4's stats (= K1's) bit for bit")


def check_k7_wgmma(fa, device, worst):
    """Phase 3, K7 on its wgmma body with an fp32 bias (check_t5_kernels
    takes it in the input's type) at T5's prefixed decoder (128 x 148,
    causal), encoder (512) and the embedding mode's encoder (576), dropout 0
    and 0.1, bf16 and fp16, phase 3's key mask: the output the same bits
    from a contiguous bias and from its rows padded to a multiple of 8
    (``padded_bias``, read in place), within phase 3's tolerance of the
    plain version; K8/K9 through autograd from K7's row stats within the
    backward tolerance of the plain version (dbias included) and equal to
    K8/K9 with its own stats pass bit for bit."""
    import torch

    for i in (T5_PREFIX_CASE, 0, ENC576_CASE):
        tag, dims, causal, _ = BIAS_CASES[i]
        for dtype_name in TC_DTYPES:
            atol, rtol = TOLERANCES[dtype_name]
            for rate in (0.0, RATE):
                q, k, v, mask, bias, dout, seed = bias_inputs(
                    dims, True, getattr(torch, dtype_name), device, 800 + i)
                bias = bias.float()
                label = (f"{tag} {dims} causal={causal} fp32 bias "
                         f"dropout={rate} {dtype_name}")
                kw = dict(kv_mask=mask, causal=causal, scale=1.0,
                          dropout_rate=rate, dropout_seed=seed)
                out = fa.flash_attention_bias(q, k, v, bias=bias, **kw)
                wrt = [t.detach().clone().requires_grad_()
                       for t in (q, k, v)]
                padded = fa.padded_bias(bias).requires_grad_()
                got = fa.flash_attention_bias(*wrt, bias=padded, **kw)
                grads = torch.autograd.grad(got, wrt + [padded], dout)
                own = fa.flash_attention_bias_bwd(
                    q, k, v, mask, bias[0], out, dout, causal=causal,
                    scale=1.0, dropout_rate=rate, dropout_seed=seed)
                torch.cuda.synchronize(device)
                if not torch.equal(got.detach(), out):
                    fail(f"K7 {label}: a row-padded bias gives other bits")
                ref = fa.bias_attention_reference(q, k, v, bias=bias, **kw)
                err = float((out.float() - ref.float()).abs().max())
                key = wkey("flash_attention_bias", dtype_name)
                worst[key] = max(worst[key], err)
                if not _within(out, ref, atol, rtol):
                    fail(f"K7 {label}: {err:.3e} from its plain version")
                refs = fa.bias_attention_bwd_reference(
                    q, k, v, mask, bias, out, dout, causal=causal, scale=1.0,
                    dropout_rate=rate, dropout_seed=seed)
                _grads_within("flash_attention_bias_bwd", grads, refs,
                              dtype_name, label, worst)
                if not all(torch.equal(a, b) for a, b in zip(
                        grads, (*own[:3], own[3][None]))):
                    fail(f"K8/K9 {label} from K7's stats differs from K8/K9 "
                         "with its own stats pass")
        print(f"[check] K7 wgmma body {tag} {dims} with an fp32 bias, "
              "dropout 0 and 0.1, bf16 and fp16: ok; a row-padded bias the "
              "same bits; K8/K9 from K7's stats == its own stats pass")


# K8/K9 against K3: ((B, S, H), key mask), each causal and not, no bias,
# dropout 0: T5's encoder shape with a pad gap and a fully masked sample,
# and a ragged length with the prompt and summary hole
K8K9_K3_CASES = [((4, 512, 12), "gap_fully_masked"), ((3, 333, 2), "hole333")]
# the kernels K8/K9 launches in bf16 and fp16 with a bias or dropout, by
# BIAS_CASES index: at the encoder the wgmma dQ and dK/dV bodies in two
# launches, at the decoder both in one grid; and those K5 and K8/K9
# launched before (the delta pass and the mma.sync tiles), as the profiler
# names them
K8K9_EVENTS = {0: ("allheads_dq_kernel", "allheads_dkdv_kernel"),
               1: ("allheads_dq_dkdv_kernel",)}
RETIRED_BWD = ("attention_delta_kernel", "attention_bwd_dq_tc_kernel",
               "attention_bwd_dkdv_tc_kernel")
# the NaN-primed case: (B, S, H), causal, keys 64-127 masked in every
# sample (a whole key tile); sizes that keep every buffer but the partial
# below 1 MiB, so that the caching allocator hands the partial the block
# freed just before
K8K9_NAN_DIMS = (2, 192, 4)


def nan_primed_bias_bwd(fa, q, k, v, mask, bias, out, dout, **kw):
    """K8/K9 (from kw's row stats) right after a block of its partial's
    size was filled with NaN and freed; fails unless the allocator hands
    that block back for the same size, as the wrapper's partial takes."""
    import torch

    n = q.shape[0] * q.shape[2] * q.shape[1] * k.shape[1]
    primed = torch.full((n,), float("nan"), device=q.device)
    ptr = primed.data_ptr()
    del primed
    again = torch.empty(n, device=q.device)
    if again.data_ptr() != ptr:
        fail("the caching allocator did not hand the NaN-filled block back")
    del again
    return fa.flash_attention_bias_bwd(q, k, v, mask, bias, out, dout, **kw)


def check_k8_k9_wgmma(fa, device, worst):
    """Phase 3, K8/K9 on the bias form of K3's wgmma bodies, bf16 and fp16:
    with no bias and dropout 0 at sq == sk (K8K9_K3_CASES, causal and not)
    equal to K3's entry given the same out and row stats, bit for bit;
    one call at the encoder and one at the decoder (bias and dropout, from
    K7's stats) profiled, their traces holding the wgmma bodies' events
    (two launches at the encoder, one grid of both at the decoder) and none
    of the delta pass or the mma.sync tiles; and a causal case with a fully
    masked key tile, bias and dropout, run right after its partial's block
    was filled with NaN and freed: dbias finite, exactly 0 where every
    sample's logit is masked, and every gradient within the backward
    tolerance of the plain version."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for dtype_name in TC_DTYPES:
        dt = getattr(torch, dtype_name)
        for (b, s, h), mask_kind in K8K9_K3_CASES:
            for causal in (False, True):
                q, k, v, mask, dout = flash_inputs(
                    (b, s, s, h, h), mask_kind, dt, device, 1100 + s)
                out, m, l = fa.flash_attention_allheads_stats(
                    q, k, v, kv_mask=mask, causal=causal)
                k3 = fa.flash_attention_allheads_bwd(
                    q, k, v, mask, out, dout, causal=causal, row_max=m,
                    row_sum=l)
                k8k9 = fa.flash_attention_bias_bwd(
                    q, k, v, mask, None, out, dout, causal=causal,
                    row_max=m, row_sum=l)
                torch.cuda.synchronize(device)
                label = f"({b}, {s}, {s}, {h}) {mask_kind} causal={causal}"
                if k8k9[3] is not None:
                    fail(f"K8/K9 without a bias returned a dbias at {label}")
                for name, g, r in zip(("dq", "dk", "dv"), k8k9, k3):
                    if not torch.equal(g, r):
                        fail(f"K8/K9 without a bias or dropout differs from "
                             f"K3 in {name} at {label} {dtype_name} (max abs "
                             f"{float((g.float() - r.float()).abs().max()):.3e})")

        # one call a shape profiled: the wgmma bodies, no delta pass, no
        # mma.sync tile
        for i, events in K8K9_EVENTS.items():
            tag, dims, causal, _ = BIAS_CASES[i]
            q, k, v, mask, bias, dout, seed = bias_inputs(dims, True, dt,
                                                          device, 1200)
            kw = dict(causal=causal, scale=1.0, dropout_rate=RATE,
                      dropout_seed=seed)
            out, m, l = fa.flash_attention_bias_stats(q, k, v, bias=bias,
                                                      kv_mask=mask, **kw)
            fa.flash_attention_bias_bwd(q, k, v, mask, bias[0], out, dout,
                                        row_max=m, row_sum=l, **kw)
            torch.cuda.synchronize(device)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fa.flash_attention_bias_bwd(q, k, v, mask, bias[0], out,
                                            dout, row_max=m, row_sum=l, **kw)
                torch.cuda.synchronize(device)
            names = [e.key for e in prof.key_averages()
                     if e.device_type.name == "CUDA"]
            seen = {k_: sum(k_ in n for n in names)
                    for k_ in events + RETIRED_BWD}
            if any(seen[k_] == 0 for k_ in events) or any(
                    seen[k_] for k_ in RETIRED_BWD):
                fail(f"K8/K9's traced call ({tag} {dims} {dtype_name}) "
                     f"launched {seen}: want {events} and no delta pass or "
                     f"mma.sync tile (kernels: {names})")
            del q, k, v, mask, bias, dout, out, m, l

        # the NaN-primed partial
        b, s, h = K8K9_NAN_DIMS
        q, k, v, _, bias, dout, seed = bias_inputs((b, s, s, h), True, dt,
                                                   device, 1300)
        mask = torch.ones(b, s, dtype=torch.int32, device=device)
        mask[:, 64:128] = 0
        mask[1, 150:] = 0
        kw = dict(causal=True, scale=1.0, dropout_rate=RATE,
                  dropout_seed=seed)
        out, m, l = fa.flash_attention_bias_stats(q, k, v, bias=bias,
                                                  kv_mask=mask, **kw)
        got = nan_primed_bias_bwd(fa, q, k, v, mask, bias[0], out, dout,
                                  row_max=m, row_sum=l, **kw)
        torch.cuda.synchronize(device)
        dbias = got[3].float()
        i = torch.arange(s, device=device)[:, None]
        masked = (i < torch.arange(s, device=device)[None, :]) | (
            mask == 0).all(0)[None, :]
        label = f"NaN-primed {(b, s, s, h)} causal {dtype_name}"
        if not bool(torch.isfinite(dbias).all()):
            fail(f"K8/K9 {label}: dbias holds a non-finite value")
        if bool((dbias[:, masked] != 0).any()):
            fail(f"K8/K9 {label}: dbias is not 0 where every sample's logit "
                 f"is masked")
        refs = fa.bias_attention_bwd_reference(
            q, k, v, mask, bias, out, dout, **kw)
        _grads_within("flash_attention_bias_bwd", got[:3] + (got[3][None],),
                      refs, dtype_name, label, worst)
    print("[check] K8/K9 wgmma bodies: without a bias or dropout = K3 from "
          f"the same stats bit for bit at {K8K9_K3_CASES}, causal and not; "
          f"traced calls launched {K8K9_EVENTS} and none of "
          f"{RETIRED_BWD}; a NaN-primed partial at (B, S, H) "
          f"{K8K9_NAN_DIMS} causal "
          "with a masked key tile: dbias finite, 0 where every logit is "
          "masked, within tolerance; bf16 and fp16")


# K5 against K6 given K4's stats, and its traced kernels: (name, (B, Sq,
# Sk, H, K/V heads), head dim, key mask, the kernels its call launches):
# T5's cross-attention (96 dQ and 384 dK/dV blocks: one grid) and
# MPT-2.7B's (1280 and 128: dQ, then dK/dV), each after the stats pass
K5_CASES = [("t5 cross", (4, 128, 512, 12, 12), 64, "gap",
             ("allheads_fwd_kernel", "allheads_dq_dkdv_kernel")),
            ("mpt-2.7b cross", (4, 640, 64, 32, 32), 80, "gap_fully_masked",
             ("allheads_fwd_kernel", "allheads_dq_kernel",
              "allheads_dkdv_kernel"))]


def check_k5_wgmma(fa, device):
    """Phase 3, K5 on K3's wgmma bodies after its stats pass, bf16 and
    fp16, at K5_CASES with the key mask and without one (a null pointer):
    equal to K6 given K4's row stats and to itself run again, bit for bit;
    one call a case profiled, its trace holding the stats pass and the
    wgmma dQ and dK/dV kernels and none of the delta pass or the mma.sync
    tiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for tag, dims, d, mask_kind, events in K5_CASES:
        for dtype_name in TC_DTYPES:
            q, k, v, mask, dout = flash_inputs(
                dims, mask_kind, getattr(torch, dtype_name), device, 1400, d)
            label = f"{tag} {dims} d{d} {dtype_name}"
            for kv_mask in (mask, None):
                out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=kv_mask)
                k5 = fa.flash_attention_bwd(q, k, v, kv_mask, out, dout)
                again = fa.flash_attention_bwd(q, k, v, kv_mask, out, dout)
                k6 = fa.flash_attention_blocked_bwd(q, k, v, kv_mask, out,
                                                    dout, m, l, causal=False)
                torch.cuda.synchronize(device)
                for name, g, g2, g6 in zip(("dq", "dk", "dv"), k5, again, k6):
                    if not (torch.equal(g, g6) and torch.equal(g, g2)):
                        fail(f"K5's {name} at {label} (mask "
                             f"{kv_mask is not None}) differs from K6's "
                             "given K4's stats or from its own second call")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fa.flash_attention_bwd(q, k, v, mask, out, dout)
                torch.cuda.synchronize(device)
            names = [e.key for e in prof.key_averages()
                     if e.device_type.name == "CUDA"]
            seen = {k_: sum(k_ in n for n in names)
                    for k_ in events + RETIRED_BWD}
            if any(seen[k_] == 0 for k_ in events) or any(
                    seen[k_] for k_ in RETIRED_BWD):
                fail(f"K5's traced call ({label}) launched {seen}: want "
                     f"{events} and no delta pass or mma.sync tile "
                     f"(kernels: {names})")
            del q, k, v, mask, dout, out, m, l, k5, again, k6
    print(f"[check] K5 wgmma bodies at {[c[:3] for c in K5_CASES]}, bf16 "
          "and fp16, with a key mask and without: = K6 from K4's stats and = "
          "its own second call, bit for bit; traced calls launched "
          f"{[c[4] for c in K5_CASES]} and none of {RETIRED_BWD}")


def dkey(name: str, d: int) -> str:
    """A kernel's key at head dim d in the worst-error table and the
    kernels line (64 keeps the plain name)."""
    return name if d == 64 else f"{name}[d{d}]"


def check_head_dim_kernels(fa, device, worst):
    """Phase 3 at head dims 80 and 128, bf16, fp16 and fp32: K1 and K3 at
    the self-attention shapes, K4 and K5 (through autograd) at every case,
    K4 with its row stats and K6 at the causal ones, each against its plain
    version at phase 3's tolerances, and K6 against K3 and K5
    (``k6_against_k3_and_k5``). bf16 and fp16 launches must take the
    tensor-core bodies."""
    import torch

    names = ("flash_attention_allheads", "flash_attention_allheads_bwd",
             "flash_attention", "flash_attention_bwd",
             "flash_attention_blocked_bwd")
    for i, (tag, (b, sq, sk, h, d), causal, mask_kind) in enumerate(
            HEAD_DIM_CASES):
        label = f"{tag} {(b, sq, sk, h, d)} causal={causal} mask={mask_kind}"
        for dtype_name, (atol, rtol) in TOLERANCES.items():
            before = {n: (getattr(fa, n).launches, getattr(fa, n).launches_tc)
                      for n in names}
            q, k, v, mask, dout = flash_inputs(
                (b, sq, sk, h, h), mask_kind, getattr(torch, dtype_name),
                device, 500 + i, d)
            kw = dict(kv_mask=mask, causal=causal)
            report = []

            def forward(name, got, ref):
                err = float((got.float() - ref.float()).abs().max())
                key = wkey(dkey(name, d), dtype_name)
                worst[key] = max(worst[key], err)
                report.append(f"{name} {err:.3e}")
                if not _within(got, ref, atol, rtol):
                    fail(f"{name} {label} {dtype_name} disagrees with its "
                         f"plain version ({err:.3e})")

            def backward(name, got, ref):
                table = collections.defaultdict(float)
                report.append(f"{name} " + _grads_within(
                    name, got, ref, dtype_name, label, table))
                key = wkey(dkey(name, d), dtype_name)
                worst[key] = max(worst[key], *table.values())

            if sq == sk:
                out = fa.flash_attention_allheads(q, k, v, **kw)
                torch.cuda.synchronize(device)
                plain_out = fa.allheads_attention_reference(q, k, v, **kw)
                forward("flash_attention_allheads", out, plain_out)
                backward("flash_attention_allheads_bwd",
                         fa.flash_attention_allheads_bwd(
                             q, k, v, mask, plain_out, dout, causal=causal),
                         fa.allheads_attention_bwd_reference(
                             q, k, v, mask, plain_out, dout, causal=causal))
            qg, kg, vg = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            out = fa.flash_attention(qg, kg, vg, **kw)
            grads = torch.autograd.grad(out, (qg, kg, vg), dout)
            torch.cuda.synchronize(device)
            out = out.detach()
            forward("flash_attention", out,
                    fa.flash_attention_reference(q, k, v, **kw))
            backward("flash_attention_bwd", grads,
                     fa.flash_attention_bwd_reference(q, k, v, mask, out,
                                                      dout, causal=causal))
            if causal:
                out, m, l = fa.flash_attention_stats(q, k, v, **kw)
                torch.cuda.synchronize(device)
                ref = fa.flash_attention_reference(q, k, v, with_stats=True,
                                                   **kw)
                forward("flash_attention", out, ref[0])
                for what, g, r in zip(("max", "sum"), (m, l), ref[1:]):
                    err = float((g - r).abs().max())
                    key = wkey(dkey("flash_attention[stats]", d), dtype_name)
                    worst[key] = max(worst[key], err)
                    if not _within(g, r, *STATS_TOLERANCES):
                        fail(f"flash_attention_stats {label} {dtype_name}: "
                             f"row {what} {err:.3e} from the plain version")
                got = fa.flash_attention_blocked_bwd(q, k, v, mask, out,
                                                     dout, m, l, causal=True)
                backward("flash_attention_blocked_bwd", got,
                         fa.flash_attention_blocked_bwd_reference(
                             q, k, v, mask, out, dout, m, l, causal=True))
                k5 = fa.flash_attention_bwd(q, k, v, mask, out, dout,
                                            causal=True)
                torch.cuda.synchronize(device)
                report.append("K6 " + k6_against_k3_and_k5(
                    fa, q, k, v, mask, out, dout, m, l, got, k5, dtype_name,
                    label))
            half = dtype_name in TC_DTYPES
            for n in names:
                runs = getattr(fa, n).launches - before[n][0]
                tc = getattr(fa, n).launches_tc - before[n][1]
                if tc != (runs if half else 0):
                    fail(f"{n} {label} {dtype_name}: {tc} of {runs} "
                         f"launches on the tensor-core body")
            print(f"[check] head dim {d}: {label} {dtype_name}: "
                  f"{'; '.join(report)} ok")
            del q, k, v, mask, dout, out, grads
    torch.cuda.empty_cache()


def kernel_keep_mask(fa, b, sq, sk, h, seed, device, dtype):
    """(B, H, Sq, Sk) bool: the elements K7 keeps, read off its output (in
    ``dtype``: bf16 and fp16 run the tensor-core body, fp32 the scalar
    one). With
    q = 0 and one 64-key window unmasked, P is 1/64 on the window's keys,
    and with v the identity on the window, out[..., d] is the keep factor
    of key window + d over 64: zero exactly where it was dropped."""
    import torch

    q = torch.zeros(b, sq, h, 64, device=device, dtype=dtype)
    keep = torch.zeros(b, h, sq, sk, dtype=torch.bool, device=device)
    for w0 in range(0, sk, 64):
        n = min(64, sk - w0)
        mask = torch.zeros(b, sk, dtype=torch.int32, device=device)
        mask[:, w0:w0 + n] = 1
        v = torch.zeros(b, sk, h, 64, device=device, dtype=dtype)
        v[:, w0:w0 + n, :, :n] = torch.eye(n, device=device)[:, None, :]
        out = fa.flash_attention_bias(q, torch.zeros_like(v), v,
                                      kv_mask=mask, scale=1.0,
                                      dropout_rate=RATE, dropout_seed=seed)
        keep[..., w0:w0 + n] = (out[..., :n] > 0).permute(0, 2, 1, 3)
    return keep


def check_dropout_mask(fa, dims, device, dtype) -> float:
    """K7's kept elements equal the plain version's bits exactly; returns
    the kept fraction (0.9 expected, within 6 sigma)."""
    import torch
    from mmgl_tpu_torch.ops import attention as att

    b, sq, sk, h = dims
    seed = torch.tensor([sq * 1000003 + sk, 7], dtype=torch.int64,
                        device=device)
    got = kernel_keep_mask(fa, b, sq, sk, h, seed, device, dtype)
    want = att.dropout_bits(seed, (b, h, sq, sk)) < att.dropout_threshold(
        RATE)[0]
    frac = float(got.float().mean())
    sigma = (RATE * (1 - RATE) / got.numel()) ** 0.5
    same = bool(torch.equal(got, want))
    print(f"[check] dropout mask of flash_attention_bias {dims} {dtype}: "
          f"{'equal to' if same else 'DIFFERS from'} the plain version's "
          f"bit for bit; kept fraction {frac:.6f} (0.9 +- 6 sigma = "
          f"{6 * sigma:.2e})")
    if not same or abs(frac - (1 - RATE)) > 6 * sigma:
        fail(f"the dropout mask of flash_attention_bias at {dims} is wrong")
    return frac


class ShapeTally:
    """K7's and K8/K9's launches by (Sq, Sk), K4's and K5's by (Sq, Sk),
    K2's by (S, causal), K4's launches that keep the rows' stats by dtype
    name, and K1-K5's launches by (wrapper, head dim), inside a ``with``
    block, counted where their launchers run (K8 and K9 are one wrapper,
    told apart by shape)."""

    def __init__(self, fa):
        self.fa = fa
        self.fwd, self.bwd, self.stats = {}, {}, {}
        self.flash, self.flash_bwd = {}, {}
        self.fused = collections.Counter()
        self.dims = collections.Counter()

    def _wrap_bwd(self, fn):
        def tallied(q, k, *a, **kw):
            self.dims[("flash_attention_bwd", q.shape[-1])] += 1
            key = (q.shape[1], k.shape[1])
            self.flash_bwd[key] = self.flash_bwd.get(key, 0) + 1
            return fn(q, k, *a, **kw)
        return tallied

    def _wrap(self, fn, table):
        def tallied(q, k, *a, **kw):
            key = (q.shape[1], k.shape[1])
            table[key] = table.get(key, 0) + 1
            return fn(q, k, *a, **kw)
        return tallied

    def _wrap_fused(self, fn):
        def tallied(q, k, v, kv_mask, causal, scale):
            self.dims[("fused_heads_attention", q.shape[-1])] += 1
            self.fused[(q.shape[1], bool(causal))] += 1
            return fn(q, k, v, kv_mask, causal, scale)
        return tallied

    def _wrap_flash(self, fn):
        def tallied(q, k, v, kv_mask, causal, scale, with_stats):
            self.dims[("flash_attention", q.shape[-1])] += 1
            shape = (q.shape[1], k.shape[1])
            self.flash[shape] = self.flash.get(shape, 0) + 1
            if with_stats:
                key = str(q.dtype).removeprefix("torch.")
                self.stats[key] = self.stats.get(key, 0) + 1
            return fn(q, k, v, kv_mask, causal, scale, with_stats)
        return tallied

    def _wrap_allheads(self, fn, name):
        def tallied(q, *a, **kw):
            self.dims[(name, q.shape[-1])] += 1
            return fn(q, *a, **kw)
        return tallied

    def __enter__(self):
        self.saved = (self.fa._launch_bias, self.fa._launch_bias_bwd,
                      self.fa._launch_fused, self.fa._launch_bwd,
                      self.fa._launch_allheads, self.fa._launch_allheads_bwd,
                      self.fa._launch_flash)
        self.fa._launch_bias = self._wrap(self.saved[0], self.fwd)
        self.fa._launch_bias_bwd = self._wrap(self.saved[1], self.bwd)
        self.fa._launch_fused = self._wrap_fused(self.saved[2])
        self.fa._launch_bwd = self._wrap_bwd(self.saved[3])
        self.fa._launch_allheads = self._wrap_allheads(
            self.saved[4], "flash_attention_allheads")
        self.fa._launch_allheads_bwd = self._wrap_allheads(
            self.saved[5], "flash_attention_allheads_bwd")
        self.fa._launch_flash = self._wrap_flash(self.saved[6])
        return self

    def __exit__(self, *exc):
        (self.fa._launch_bias, self.fa._launch_bias_bwd,
         self.fa._launch_fused, self.fa._launch_bwd, self.fa._launch_allheads,
         self.fa._launch_allheads_bwd, self.fa._launch_flash) = self.saved
        return False


class PlainCheck:
    """Inside a ``with`` block, every launch of K1-K5 and K7-K9 held
    against its plain version on the same inputs, at phase 3's tolerances
    for its dtype: the values a model's step gives the kernels, where phase
    3 gives random ones. Counted where the launchers run; the worst error
    of each kernel kept under ``worst``, the calls under ``calls``.

    Phase 3's forward atol is for v of unit scale. Attention is linear in
    v, and a half-precision forward rounds each probability to the element
    type before P V, so its rounding error is a few roundings of max |v|,
    whatever the output's own size (LoRA's seeded adapter at alpha / r = 2,
    phase 20, gives v a scale near 6). So a forward launch is held to
    atol x max(1, max |v|) and phase 3's rtol: phase 3's tolerance itself
    where v is of unit scale. Each launch with max |v| > 1 is kept under
    ``scaled``."""

    LAUNCHERS = ("_launch_fused", "_launch_bwd", "_launch_bias",
                 "_launch_bias_bwd", "_launch_allheads",
                 "_launch_allheads_bwd", "_launch_flash")

    def __init__(self, fa, tag):
        self.fa, self.tag = fa, tag
        self.worst, self.calls = collections.defaultdict(float), 0
        self.scaled = []

    def _forward(self, name, got, ref, v, label):
        atol, rtol = TOLERANCES[str(got.dtype).removeprefix("torch.")]
        v_max = float(v.abs().max())
        atol *= max(1.0, v_max)
        err = float((got.float() - ref.float()).abs().max())
        self.worst[name] = max(self.worst[name], err)
        self.calls += 1
        if v_max > 1:
            self.scaled.append({"name": name, "shape": str(label),
                                "max_abs_v": v_max, "atol": atol,
                                "vs_plain": err})
        if not _within(got, ref, atol, rtol):
            fail(f"{self.tag}: {name} {label} is {err:.3e} from its plain "
                 f"version on the same inputs (atol {atol:g} at max |v| "
                 f"{v_max:g}, rtol {rtol:g})")

    def _backward(self, name, got, ref, label):
        dtype_name = str(got[0].dtype).removeprefix("torch.")
        worst = collections.defaultdict(float)
        _grads_within(name, got, ref, dtype_name, f"{self.tag} {label}",
                      worst)
        self.worst[name] = max(self.worst[name], *worst.values())
        self.calls += 1

    def __enter__(self):
        fa = self.fa
        saved = self.saved = {n: getattr(fa, n) for n in self.LAUNCHERS}

        def launch_fused(q, k, v, kv_mask, causal, scale):
            out = saved["_launch_fused"](q, k, v, kv_mask, causal, scale)
            ref = fa.fused_heads_attention_reference(
                q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)
            self._forward("fused_heads_attention", out, ref, v,
                          tuple(q.shape))
            return out

        def launch_flash(q, k, v, kv_mask, causal, scale, with_stats):
            got = saved["_launch_flash"](q, k, v, kv_mask, causal, scale,
                                         with_stats)
            ref = fa.flash_attention_reference(q, k, v, kv_mask=kv_mask,
                                               causal=causal, scale=scale)
            self._forward("flash_attention", got[0], ref, v,
                          (tuple(q.shape), tuple(k.shape)))
            return got

        def launch_bwd(q, k, v, kv_mask, out, dout, causal, scale):
            name = "flash_attention_bwd"
            got = saved["_launch_bwd"](q, k, v, kv_mask, out, dout, causal,
                                       scale)
            ref = getattr(fa, KERNELS[name][0])(q, k, v, kv_mask, out, dout,
                                                causal=causal, scale=scale)
            self._backward(name, got, ref, tuple(q.shape))
            return got

        def launch_bias(q, k, v, kv_mask, bias, seed, causal, scale, thr,
                        keep_inv, with_stats):
            if thr:
                fail(f"{self.tag}: K7 with dropout in a checked step")
            got = saved["_launch_bias"](q, k, v, kv_mask, bias, seed, causal,
                                        scale, thr, keep_inv, with_stats)
            ref = fa.bias_attention_reference(
                q, k, v, bias=None if bias is None else bias[None],
                kv_mask=kv_mask, causal=causal, scale=scale)
            self._forward("flash_attention_bias", got[0], ref, v,
                          (tuple(q.shape), tuple(k.shape)))
            return got

        def launch_bias_bwd(q, k, v, kv_mask, bias, seed, out, dout, causal,
                            scale, thr, keep_inv, *stats):
            if thr:
                fail(f"{self.tag}: K8/K9 with dropout in a checked step")
            got = saved["_launch_bias_bwd"](q, k, v, kv_mask, bias, seed,
                                            out, dout, causal, scale, thr,
                                            keep_inv, *stats)
            ref = list(fa.bias_attention_bwd_reference(
                q, k, v, kv_mask, None if bias is None else bias[None], out,
                dout, causal=causal, scale=scale))
            if ref[3] is not None:
                ref[3] = ref[3][0]
            self._backward("flash_attention_bias_bwd", got, ref,
                           (tuple(q.shape), tuple(k.shape)))
            return got

        def launch_allheads(q, k, v, kv_mask, causal, scale, with_stats):
            got = saved["_launch_allheads"](q, k, v, kv_mask, causal, scale,
                                            with_stats)
            ref = fa.allheads_attention_reference(
                q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)
            self._forward("flash_attention_allheads", got[0], ref, v,
                          tuple(q.shape))
            return got

        def launch_allheads_bwd(q, k, v, kv_mask, out, dout, causal, scale,
                                row_max, row_sum):
            got = saved["_launch_allheads_bwd"](q, k, v, kv_mask, out, dout,
                                                causal, scale, row_max,
                                                row_sum)
            ref = fa.allheads_attention_bwd_reference(
                q, k, v, kv_mask, out, dout, causal=causal, scale=scale)
            self._backward("flash_attention_allheads_bwd", got, ref,
                           tuple(q.shape))
            return got

        for name, fn in zip(self.LAUNCHERS, (launch_fused, launch_bwd,
                                             launch_bias,
                                             launch_bias_bwd, launch_allheads,
                                             launch_allheads_bwd,
                                             launch_flash)):
            setattr(fa, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.fa, name, fn)
        return False


class LaunchTally:
    """Launches of each kernel inside calls of a wrapped function."""

    def __init__(self, fa, names):
        self.fa, self.names, self.calls = fa, names, []

    def wrap(self, fn):
        def counted(*a, **kw):
            before = {n: getattr(self.fa, n).launches for n in self.names}
            out = fn(*a, **kw)
            self.calls.append({n: getattr(self.fa, n).launches - before[n]
                               for n in self.names})
            return out
        return counted


def run_test_pass(cli, fa, device, argv, kernels, per_eval=None,
                  per_generate=None, tag="opt"):
    """Phases 4 and 6: the --test pass at full width; the kernels must
    launch, and, where given, exactly per_eval / per_generate times in each
    eval step / generated batch. Returns (the test pass, results, launches,
    sections/s after the warm-up batch, peak bytes)."""
    import torch

    args, dev = cli.parse_cli(argv)
    test = cli.prepare(args, dev)
    vocab = (test.fcfg.opt or test.fcfg.t5).vocab_size
    shapes = []
    evals, gens = LaunchTally(fa, KERNELS), LaunchTally(fa, KERNELS)
    test.eval_step = evals.wrap(test.eval_step)
    generate_fn = gens.wrap(test.generate_fn)

    def generate(batch):
        ids = generate_fn(batch)
        shapes.append(tuple(ids.shape))
        if not bool(((ids >= 0) & (ids < vocab)).all()):
            fail("generated ids outside the vocabulary")
        return ids

    test.generate_fn = generate
    batches = []

    def log(scalars, step):
        if "test/batch_seconds" in scalars:
            batches.append((scalars["test/batch_seconds"],
                            scalars["test/batch_sections"]))

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(fa)
    results = cli.evaluate_loop(test, args, args.start_epoch, log,
                                prefix="test")
    launches = {name: getattr(fa, name).launches for name in KERNELS}
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    check_bodies(fa, f"{tag} test", bf16=True)

    print(f"[{tag} test] results: {json.dumps(results, sort_keys=True)}")
    print(f"[{tag} test] launches: {launches}; generated shapes: {shapes}")
    print(f"[{tag} test] per eval step: {evals.calls}")
    print(f"[{tag} test] per generated batch: {gens.calls}")
    if not math.isfinite(results["loss"]):
        fail(f"test loss is not finite: {results['loss']}")
    if not shapes or any(s != (4, cli.MAX_NEW_TOKENS) for s in shapes):
        fail(f"generated ids have shapes {shapes}, expected (4, 32)")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"{name} was not launched by the {tag} test pass")
    for want, calls, what in ((per_eval, evals.calls, "eval step"),
                              (per_generate, gens.calls, "generated batch")):
        if want is not None and any(
                {n: c[n] for n in want} != want for c in calls):
            fail(f"the {tag} {what} launched {calls}, expected {want} each")
    timed = batches[1:]                    # the first batch is the warm-up
    if not timed:
        fail("the test pass ran fewer than two batches")
    rate = sum(n for _, n in timed) / sum(t for t, _ in timed)
    print(f"[{tag} test] {rate:.3f} sections/s over {len(timed)} batches "
          f"after one warm-up batch (batch seconds "
          f"{[round(t, 4) for t, _ in batches]}); peak device memory {peak} "
          f"bytes ({peak / 2**30:.3f} GiB)")
    return test, results, launches, rate, peak


def check_model_fp32(cli, fa, test, device, argv, tag):
    """Phases 4b and 6b: one sample's fp32 eval step through the kernels on
    the card (their scalar bodies) against the same seeded model on the CPU
    (plain versions)."""
    import torch
    from mmgl_tpu_torch.models.factory import build_model
    from mmgl_tpu_torch.train.steps import losses_of

    args, _ = cli.parse_cli(argv + ["--bf16", "false"])
    batch = next(iter(test.loader))
    batch = {k: v[:1] for k, v in batch.items()}
    out = {}
    for dev in (device, torch.device("cpu")):
        model, _ = build_model(args, dev,
                               vocab_size=test.tokenizer.vocab_size,
                               tokenizer=test.tokenizer)
        reset_launches(fa)
        with torch.no_grad():
            fused = model.eval()(batch)
        if dev.type == "cuda":
            check_bodies(fa, f"{tag} model fp32", bf16=False)
        out[dev.type] = (fused["logits"].float().cpu(),
                         float(losses_of(fused, test.fcfg.decoder_only,
                                         args.max_input_length,
                                         test.tokenizer.pad_token_id)[0]))
        del model, fused
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    loss_err = abs(out["cuda"][1] - out["cpu"][1])
    print(f"[{tag} model] fp32 eval, card vs CPU, one sample: logits "
          f"{tuple(out['cpu'][0].shape)} max_abs_err={err:.3e}, loss "
          f"{out['cuda'][1]:.6f} vs {out['cpu'][1]:.6f} (atol={MODEL_ATOL:g})")
    if not (err <= MODEL_ATOL and loss_err <= MODEL_ATOL):
        fail(f"the fp32 {tag} model on the card disagrees with the CPU")
    return {"max_abs_logit_err": err, "loss": [out["cuda"][1],
                                               out["cpu"][1]]}


def run_training(cli, fa, device, log_dir: str, argv, kernels,
                 per_update=None, tag="opt", per_eval=None,
                 per_generate=None, updates=TRAIN_UPDATES, idle=(),
                 zero_first=None, cache_kernels=None, warm_start=False,
                 on_build=None):
    """Phases 5, 5c, 7, 9-15: the training run at full
    width through the entry point, ``updates`` updates; ``kernels`` must
    launch inside the training steps, exactly ``per_update`` times in each
    update where given, and ``per_eval`` / ``per_generate`` times in each
    eval step (val and test) / generated batch, every launch on the
    tensor-core body. Every trainable tensor must move but those under the
    model's ``gradless_prefixes`` (the text pooler, behind the text tower's
    stop_gradient: trainable, with a zero gradient), the prefixes ``idle``
    (a zero gradient by the layout) and those ``zero_first`` = (predicate,
    reason) names, whose gradient in the first update must be exactly 0
    for that reason; no frozen tensor (the towers, and under PEFT the LM)
    may move, and the frozen set is the one peft/masks.py gives.

    With ``cache_kernels`` (--cache_neighbor_embeddings true) the run
    builds the neighbour cache of its three splits before the loop: those
    kernels (the towers') must launch there and no other. ``warm_start``:
    then a second start on the same --neighbor_cache_dir, the three splits
    wrapped anew with the run's model, must launch no kernel at all.
    ``on_build`` is called with the model the entry point built, before
    the run uses it.

    The CLI's model factory, neighbour cache, train step, eval setup and
    checkpoint restore are wrapped here, not changed: the wrappers snapshot the weights, time
    each update to a device synchronize and count the kernel launches inside
    it and inside each eval step and generated batch, and record the final
    restore. The weights' snapshot is kept on the host and the peak device
    memory is read after a garbage collection, beside the bytes resident
    before the run, so that it is the run's own. Returns a summary dict."""
    import torch

    args, dev = cli.parse_cli(argv + ["--log_dir", log_dir])
    seen = {"steps": [], "restores": [], "merges": 0, "rates": [],
            "cache": []}
    evals, gens = LaunchTally(fa, KERNELS), LaunchTally(fa, KERNELS)
    originals = {name: getattr(cli, name) for name in (
        "build_model", "make_train_step", "restore_checkpoint",
        "merge_restored_params", "_eval_setup", "cache_neighbors")}

    def build_model(*a, **kw):
        model, cfg = originals["build_model"](*a, **kw)
        seen["model"] = model
        # on the host, so that the peak device memory is the run's own
        seen["before"] = {n: p.detach().to("cpu", copy=True)
                          for n, p in model.named_parameters()}
        if on_build is not None:
            on_build(model)
        return model, cfg

    def make_train_step(*a, **kw):
        step = originals["make_train_step"](*a, **kw)
        model, optimizer = a[0], a[1]
        names = {id(p): n for n, p in model.named_parameters()}
        opt_step = optimizer.step

        def first_grads(*sa, **skw):
            # the trainable tensors whose gradient is exactly 0 in the
            # first update (after the accumulation, before the step)
            if "zero_grads" not in seen:
                seen["zero_grads"] = sorted(
                    names[id(p)] for g in optimizer.param_groups
                    for p in g["params"] if not p.grad.any())
            return opt_step(*sa, **skw)

        if zero_first is not None:
            optimizer.step = first_grads

        def counted(batch, generator=None):
            before = {n: getattr(fa, n).launches for n in KERNELS}
            torch.cuda.synchronize(device)
            start = time.perf_counter()
            metrics = step(batch, generator)
            torch.cuda.synchronize(device)
            seen["steps"].append({
                "seconds": time.perf_counter() - start,
                "sections": int(batch["input_ids"].shape[0]),
                "launches": {n: getattr(fa, n).launches - before[n]
                             for n in KERNELS},
                **{k: float(v) for k, v in metrics.items()}})
            return metrics

        return counted

    def cache_neighbors(*a, **kw):
        before = {n: getattr(fa, n).launches for n in KERNELS}
        torch.cuda.synchronize(device)
        start = time.perf_counter()
        datasets = originals["cache_neighbors"](*a, **kw)
        torch.cuda.synchronize(device)
        seen["cache"].append({
            "seconds": time.perf_counter() - start,
            "launches": {n: getattr(fa, n).launches - before[n]
                         for n in KERNELS}})
        return datasets

    def eval_setup(*a, **kw):
        setup = originals["_eval_setup"](*a, **kw)
        setup.eval_step = evals.wrap(setup.eval_step)
        setup.generate_fn = gens.wrap(setup.generate_fn)
        return setup

    def restore_checkpoint(path):
        ckpt = originals["restore_checkpoint"](path)
        seen["restores"].append((path, ckpt))
        return ckpt

    def merge_restored_params(model, params):
        originals["merge_restored_params"](model, params)
        seen["merges"] += 1

    def log(scalars, step):
        if "metrics/examples_per_sec" in scalars:
            seen["rates"].append(scalars["metrics/examples_per_sec"])

    wrappers = {"build_model": build_model,
                "make_train_step": make_train_step,
                "restore_checkpoint": restore_checkpoint,
                "merge_restored_params": merge_restored_params,
                "_eval_setup": eval_setup,
                "cache_neighbors": cache_neighbors}
    for name, fn in wrappers.items():
        setattr(cli, name, fn)
    try:
        gc.collect()    # what an earlier phase left in cycles is not the run's
        torch.cuda.synchronize(device)
        resident = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches(fa)
        results = cli.run(args, dev, log)
        launches = {name: getattr(fa, name).launches for name in KERNELS}
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        for name, fn in originals.items():
            setattr(cli, name, fn)
    bodies = check_bodies(fa, f"{tag} train", bf16=True)

    steps = seen["steps"]
    in_steps = {n: sum(s["launches"][n] for s in steps) for n in KERNELS}
    print(f"[{tag} train] results: {json.dumps(results, sort_keys=True)}")
    cache = None
    if cache_kernels is not None:
        built = {n: sum(c["launches"][n] for c in seen["cache"])
                 for n in KERNELS}
        cache = {"seconds": sum(c["seconds"] for c in seen["cache"]),
                 "launches": built}
        print(f"[{tag} train] neighbour cache of the three splits built in "
              f"{cache['seconds']:.4f} s, launching {built}")
        if (len(seen["cache"]) != 1
                or any((built[n] > 0) != (n in cache_kernels)
                       for n in KERNELS)):
            fail(f"{tag}: the neighbour cache's build launched {built}, "
                 f"expected {cache_kernels} and nothing else")
    for i, st in enumerate(steps):
        print(f"[{tag} train] update {i + 1}: loss {st['loss']:.6f} "
              f"summary_loss {st['summary_loss']:.6f} grad_norm "
              f"{st['grad_norm']:.6f} {st['seconds']:.4f} s; launches "
              f"{st['launches']}")
    print(f"[{tag} train] launches in the run {launches}, inside the "
          f"training steps {in_steps}")
    if len(steps) != updates or results["train_updates"] != len(steps):
        fail(f"{len(steps)} training updates, expected {updates}")
    for name in kernels:
        if launches[name] <= 0 or in_steps[name] <= 0:
            fail(f"{name} was not launched inside the {tag} training steps")
    if per_update is not None and any(
            {n: s["launches"][n] for n in per_update} != per_update
            for s in steps):
        fail(f"the {tag} updates launched {[s['launches'] for s in steps]},"
             f" expected {per_update} each")
    for want, calls, what in ((per_eval, evals.calls, "eval step"),
                              (per_generate, gens.calls, "generated batch")):
        if want is None:
            continue
        got = [{n: c[n] for n in want} for c in calls]
        print(f"[{tag} train] launches per {what} ({len(calls)}): {got}")
        if not calls or any(g != want for g in got):
            fail(f"the {tag} {what}s launched {got}, expected {want} each")
    values = [st[k] for st in steps
              for k in ("loss", "summary_loss", "grad_norm")]
    if not all(math.isfinite(v) for v in values + [results["loss"]]):
        fail(f"a training loss or gradient norm is not finite: {values}")

    from mmgl_tpu_torch.peft.masks import _path_trainable

    model, before = seen["model"], seen["before"]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    params = dict(model.named_parameters())
    after = {n: p.detach().cpu() for n, p in params.items()}
    still = [n for n in trainable if torch.equal(after[n], before[n])]
    moved = [n for n in frozen if not torch.equal(after[n], before[n])]
    off = tuple(getattr(model, "gradless_prefixes", ())) + tuple(idle)
    off_path = [n for n in trainable if off and n.startswith(off)]
    print(f"[{tag} train] {len(trainable) - len(still)} of {len(trainable)} "
          f"trainable tensors moved; {len(moved)} of {len(frozen)} frozen "
          f"tensors moved ({sum(n.startswith(TOWERS) for n in frozen)} of "
          f"them the towers')"
          + (f"; off the gradient path {off_path}, of which still "
             f"{[n for n in still if n in off_path]}" if off_path else ""))
    if zero_first is not None:
        predicate, reason = zero_first
        want = sorted(n for n in trainable if predicate(n)
                      and n not in off_path)
        got = [n for n in seen["zero_grads"] if n not in off_path]
        print(f"[{tag} train] exactly-zero gradients in update 1 "
              f"({len(got)} tensors), as expected: {reason}: "
              f"{got[:4]}{' ...' if len(got) > 4 else ''}")
        if got != want:
            fail(f"{tag}: the tensors with an exactly-zero gradient in "
                 f"update 1 are {got[:6]}, expected {want[:6]} ({reason})")
        off_path += want
    mask = [n for n in params if not _path_trainable(
        n, args.peft_type, args.freeze_lm)]
    still = [n for n in still if n not in off_path]
    if still or moved or not frozen or frozen != mask:
        fail(f"trainable tensors that did not move: {still[:5]}; frozen "
             f"tensors that moved: {moved[:5]}; frozen tensors against "
             f"the mask: {sorted(set(frozen) ^ set(mask))[:5]}")

    ckpt_dir = os.path.join(log_dir, "default_0", "ckpt")
    final = [c for path, c in seen["restores"] if path == ckpt_dir]
    if not final or final[-1] is None or seen["merges"] != 1:
        fail(f"the best checkpoint under {ckpt_dir} was not restored for "
             f"the test pass (restores {[p for p, _ in seen['restores']]})")
    saved = final[-1]["params"]
    if any(k.startswith(TOWERS) for k in saved) or not all(
            torch.equal(after[k], v) for k, v in saved.items()):
        fail("the test pass did not run on the restored checkpoint")
    print(f"[{tag} train] best checkpoint of epoch {final[-1]['epoch']} "
          f"({len(saved)} tensors, no tower) restored for the test pass")

    timed = steps[1:]                       # the first update is the warm-up
    rate = (sum(s["sections"] for s in timed)
            / sum(s["seconds"] for s in timed)) if timed else None
    print(f"[{tag} train] "
          + (f"{rate:.3f} sections/s over {len(timed)} updates of "
             f"{timed[0]['sections']} sections after one warm-up update"
             if timed else "one update, no rate")
          + f" (update seconds {[round(s['seconds'], 4) for s in steps]}; "
          f"the loop's own examples/s {[round(r, 3) for r in seen['rates']]}"
          f"); peak device memory {peak} bytes ({peak / 2**30:.3f} GiB, of "
          f"which {resident / 2**30:.3f} GiB resident before the run)")
    warm = None
    if warm_start:
        # a second start: the splits wrapped anew with the run's model
        tokenizer = cli.get_tokenizer(args.tokenizer_path)
        datasets = cli.setup_data(args, tokenizer)
        torch.cuda.synchronize(device)
        reset_launches(fa)
        start = time.perf_counter()
        cli.cache_neighbors(args, model, datasets, ("train", "val", "test"))
        torch.cuda.synchronize(device)
        files = sorted(os.listdir(args.neighbor_cache_dir))
        warm = {"seconds": time.perf_counter() - start,
                "launches": {n: getattr(fa, n).launches for n in KERNELS},
                "files": files}
        print(f"[{tag} train] warm start on {args.neighbor_cache_dir} "
              f"({files}): {warm['seconds']:.4f} s, launches "
              f"{warm['launches']}")
        if any(warm["launches"].values()) or len(files) != 3:
            fail(f"{tag}: the warm start launched {warm['launches']} with "
                 f"{files} cached")
    return {"sections_per_s": rate, "peak_bytes": peak,
            "resident_bytes": resident, "neighbor_cache": cache,
            "warm_start": warm,
            "launches": launches, "in_steps": in_steps,
            "launches_tc": {n: c[1] for n, c in bodies.items()},
            "losses": [s["loss"] for s in steps],
            "grad_norms": [s["grad_norm"] for s in steps],
            "update_seconds": [s["seconds"] for s in steps],
            "test_loss": results["loss"], "eval_steps": len(evals.calls),
            "generated_batches": len(gens.calls)}


def seed_zero_params(model, seeded) -> list:
    """Parameters whose name holds one of ``seeded`` (LoRA's ``lora_b``, the
    flamingo ``gating``s), zero at init, set in place to seeded
    normal(0, 0.5) values drawn on the CPU in the model's parameter order:
    the same on every device. Returns their names."""
    import torch

    g = torch.Generator().manual_seed(7)
    names = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            if any(s in name for s in seeded):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
                names.append(name)
    return names


class Head:
    """The first n samples of a dataset."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        return self.dataset[index]


def cached_batch(cli, model, dataset, n: int):
    """The first n samples of a split as the neighbour cache serves them,
    its towers run by ``model`` (no cache directory)."""
    from mmgl_tpu_torch.data.neighbor_cache import CachedNeighborDataset

    cached = CachedNeighborDataset(Head(dataset, n), model, batch_size=n,
                                   verbose=False, num_workers=1)
    return next(iter(cli.PrefetchLoader(cached, batch_size=n,
                                        num_workers=1)))


@contextlib.contextmanager
def depth_cut(size: str, layers: int):
    """The port's OPT table row of ``size`` (MPT's too) cut to ``layers``
    layers inside the block, its width unchanged."""
    from mmgl_tpu_torch.models import factory

    row = factory._OPT_SIZES[size]
    factory._OPT_SIZES[size] = (row[0], layers) + row[2:]
    try:
        yield
    finally:
        factory._OPT_SIZES[size] = row


def check_train_step(cli, fa, device, argv, kernels, tag, tol=STEP_TOL,
                     plain_on_card=False, on_cpu=True, half=False,
                     per_step=None, seeded=(), cached=False):
    """Phases 5b, 5c, 7b, 9b, 10c and 12-14: one training
    micro-step (loss, backward) of one sample in eval mode (no dropout) on
    the card; ``kernels`` must launch in it, exactly ``per_step`` times
    where given. The parameters named by ``seeded`` (zero at init: LoRA's
    B, the flamingo gates) are first given seeded non-zero values, the same
    on every device, so that what they multiply has a gradient to compare.

    fp32 (the scalar bodies): held against the same seeded model on the CPU
    within ``tol`` = (loss atol, gradient-norm rtol, largest gradient error
    as a fraction of the largest gradient). With ``plain_on_card`` the step
    also runs on the card through the plain versions, and the kernels'
    gradient error against the CPU may be at most twice the plain versions'
    (the same sums in another order); without ``on_cpu`` the plain versions
    on the card are the reference.

    ``half``: the compute dtype of ``argv`` (bf16 or fp16, the tensor-core
    bodies), and every kernel launch in the step held against its plain
    version on the same inputs (PlainCheck); the step itself must be
    finite. A whole half-precision step of a random-init T5 is no check of
    its kernels: the step through the plain versions, in the same dtype,
    is itself far from the fp32 step (its gradient norm by several percent,
    more than the kernels' rounding moves it), so each launch is compared
    where its inputs are the same.

    ``cached``: the sample as the neighbour cache serves it, its pooled
    features computed by each device's model, and the step's counts taken
    after that.

    The loss is the train step's (``make_loss_fn`` with the flags'
    ``--fused_ce`` and ``--chunked_ce``). Under ``--chunked_ce`` the card's
    model also gives, after the counts are read, the same sample's loss
    through the materialised logits, held to the chunked one at phase 3's
    tolerance for the compute dtype.

    Returns the card step's launches and the errors."""
    import torch
    from mmgl_tpu_torch.models.factory import build_model
    from mmgl_tpu_torch.train.steps import make_loss_fn

    args, _ = cli.parse_cli(argv if half else argv + ["--bf16", "false"])
    args.decoder_only = "t5" not in args.model_name_or_path
    tokenizer = cli.get_tokenizer(args.tokenizer_path)
    train_ds = cli.setup_data(args, tokenizer)[0]
    batch = next(iter(cli.PrefetchLoader(train_ds, batch_size=1,
                                         num_workers=1)))
    runs = [("card", device, False)]
    if plain_on_card and not half:
        runs.append(("card_plain", device, True))
    if on_cpu and not half:
        runs.append(("cpu", torch.device("cpu"), True))
    ref = runs[-1][0]
    out, launches, materialised = {}, {}, None
    chunked = args.chunked_ce if args.decoder_only else 0
    plain = fa._plain
    check = PlainCheck(fa, f"{tag} step")
    try:
        for which, dev, use_plain in runs:
            fa._plain = (lambda q: True) if use_plain else plain
            model, _ = build_model(args, dev, vocab_size=tokenizer.vocab_size,
                                   tokenizer=tokenizer)
            if seeded and not seed_zero_params(model, seeded):
                fail(f"{tag}: no parameter named {seeded} to seed")
            if cached:
                batch = cached_batch(cli, model, train_ds, 1)
            reset_launches(fa)
            loss_fn = make_loss_fn(model.eval(), args.decoder_only,
                                   args.max_input_length,
                                   tokenizer.pad_token_id,
                                   fused_ce=args.fused_ce, chunked_ce=chunked)
            with check if half else contextlib.nullcontext():
                loss, _ = loss_fn(batch)
                loss.backward()
            if which == "card":
                torch.cuda.synchronize(dev)
                launches = {n: getattr(fa, n).launches for n in KERNELS}
                check_bodies(fa, f"{tag} step {'half' if half else 'fp32'}",
                             bf16=half)
                if chunked:
                    with torch.no_grad():
                        materialised = float(make_loss_fn(
                            model, True, args.max_input_length,
                            tokenizer.pad_token_id)(batch)[0])
            grads = {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters()
                     if p.requires_grad and p.grad is not None}
            norm = math.sqrt(sum(float(g.double().pow(2).sum())
                                 for g in grads.values()))
            out[which] = (float(loss.detach()), norm, grads)
            del model, loss
    finally:
        fa._plain = plain
    for name in kernels:
        if launches[name] <= 0:
            fail(f"{name} was not launched in the {tag} micro-step")
    if per_step is not None and {n: launches[n] for n in per_step} \
            != per_step:
        fail(f"the {tag} micro-step launched {launches}, expected "
             f"{per_step}")
    loss_c, norm_c, _ = out["card"]
    if half:
        print(f"[{tag} step] half-precision training micro-step, one "
              f"sample: loss {loss_c:.7f}, grad_norm {norm_c:.6f}; "
              f"{check.calls} launches each within phase 3's tolerance "
              f"(the forward's atol x max(1, max |v|)) of its plain version "
              f"on the same inputs, worst "
              f"{dict(check.worst)}; card launches {launches}")
        scaled = None
        if check.scaled:
            worst = max(check.scaled, key=lambda t: t["vs_plain"] / t["atol"])
            scaled = {"launches": len(check.scaled),
                      "max_abs_v": max(t["max_abs_v"] for t in check.scaled),
                      "worst": worst}
            print(f"[{tag} step] {len(check.scaled)} forward launches at max "
                  f"|v| > 1, their atol scaled by it: largest max |v| "
                  f"{scaled['max_abs_v']:g}; nearest its limit {worst}")
        if not (math.isfinite(loss_c) and math.isfinite(norm_c)):
            fail(f"the {tag} half-precision micro-step is not finite")
        if check.calls != sum(launches.values()):
            fail(f"{tag}: {check.calls} launches checked of "
                 f"{sum(launches.values())}")
        summary = {"loss": loss_c, "grad_norm": norm_c,
                   "checked_launches": check.calls,
                   "max_abs_err_vs_plain": dict(check.worst),
                   "scaled_forward": scaled, "launches": launches}
        if chunked:
            atol, rtol = TOLERANCES[args.compute_dtype]
            print(f"[{tag} step] the same sample's loss, --chunked_ce "
                  f"{chunked} {loss_c:.7f} against the materialised logits' "
                  f"{materialised:.7f}: difference "
                  f"{abs(loss_c - materialised):.3e} (atol {atol:g}, rtol "
                  f"{rtol:g})")
            if not abs(loss_c - materialised) <= atol + rtol * abs(
                    materialised):
                fail(f"{tag}: the chunked CE's loss is not the materialised "
                     "logits' loss")
            summary["materialised_loss"] = materialised
        return summary
    loss_h, norm_h, g_h = out[ref]
    scale = max(float(g.abs().max()) for g in g_h.values())
    errs = {}
    for which in out:
        if which == ref:
            continue
        per = {n: float((out[which][2][n] - g_h[n]).abs().max()) for n in g_h}
        worst = max(per, key=per.get)
        errs[which] = per[worst]
        print(f"[{tag} step] fp32 training micro-step, {which} vs {ref}, "
              f"one sample: loss {out[which][0]:.7f} vs {loss_h:.7f}; "
              f"grad_norm {out[which][1]:.6f} vs {norm_h:.6f}; max abs grad "
              f"err {per[worst]:.3e} (in {worst}) of max |grad| {scale:.3e} "
              f"over {len(g_h)} tensors")
    loss_atol, norm_rtol, grad_tol = tol
    print(f"[{tag} step] tolerance: loss atol {loss_atol:g}, norm rtol "
          f"{norm_rtol:g}, grad err <= {grad_tol:g} x max |grad|"
          + (", and at most 2x the plain versions' on the card"
             if plain_on_card and on_cpu else "")
          + f"; card launches {launches}")
    if not (abs(loss_c - loss_h) <= loss_atol
            and abs(norm_c - norm_h) <= norm_rtol * norm_h
            and errs["card"] <= grad_tol * scale
            and errs["card"] <= 2 * errs.get("card_plain", math.inf)):
        fail(f"the fp32 {tag} training step on the card disagrees with the "
             "CPU")
    return {"reference": ref, "loss": [loss_c, loss_h],
            "grad_norm": [norm_c, norm_h],
            "max_abs_grad_err": errs, "max_abs_grad": scale,
            "launches": launches}


# ---- phase 8: timings and bounds -------------------------------------------

def allowed_pairs(mask, sq: int, causal: bool) -> float:
    """The (query, key) pairs whose logits the masks leave, summed over the
    batch (per head); a fully masked row needs all its keys (P uniform)."""
    import torch

    b, sk = mask.shape
    i = torch.arange(sq, device=mask.device)[:, None] + (sk - sq)
    j = torch.arange(sk, device=mask.device)[None, :]
    vis = (i >= j) if causal else torch.ones(sq, sk, dtype=torch.bool,
                                             device=mask.device)
    allowed = vis[None] & mask.bool()[:, None, :]
    per_row = allowed.sum(-1)
    per_row = torch.where(per_row == 0, torch.full_like(per_row, sk),
                          per_row)
    return float(per_row.sum())


def bound_ms(flops: float, nbytes: float):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def float_mask(mask, sq, causal, bias, dtype):
    """The masks (and bias) as scaled_dot_product_attention's float
    attn_mask, (B, H or 1, Sq, Sk): -1e30 where masked, as the kernels."""
    import torch

    b, sk = mask.shape
    allowed = mask.bool()[:, None, None, :].expand(b, 1, sq, sk)
    if causal:
        i = torch.arange(sq, device=mask.device)[:, None] + (sk - sq)
        allowed = allowed & (i >= torch.arange(sk, device=mask.device))
    add = torch.zeros(b, 1, sq, sk, device=mask.device, dtype=torch.float32)
    if bias is not None:
        add = add + bias.float()
    return add.masked_fill(~allowed, -1e30).to(dtype)


def median_ms(fns, device, rounds: int = 5, run: int = TIMING_RUN):
    """Median ms of each callable, in rounds of plain, kernel, library,
    library, kernel, plain (CUDA events, after a warm-up); a sample is the
    mean of ``run`` calls back to back (PLAIN_RUN of the plain version's),
    so that the host's time to launch a call overlaps the card's work on
    the one before, as it does on the main path."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize(device)
    order = [k for k in ("plain", "kernel", "library") if k in fns]
    order = order + order[::-1]
    samples = {k: [] for k in fns}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(rounds * 2):
        for which in order:
            calls = PLAIN_RUN if which == "plain" else run
            start.record()
            for _ in range(calls):
                fns[which]()
            end.record()
            end.synchronize()
            samples[which].append(start.elapsed_time(end) / calls)
    return {k: statistics.median(s) for k, s in samples.items()}, len(
        samples["kernel"])


def _bhsd(*ts):
    """BSHD tensors as scaled_dot_product_attention's (B, H, S, D)."""
    return [t.transpose(1, 2).contiguous() for t in ts]


def _sdpa_fwd(q, k, v, am, p=0.0, scale=None):
    import torch.nn.functional as F

    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, dropout_p=p, scale=scale)


def _sdpa_bwd(q, k, v, am, dout, p=0.0, scale=None, bias_grad=False):
    """The backward of one scaled_dot_product_attention call (the float
    mask's gradient too where it holds a bias), its forward run once."""
    import torch
    import torch.nn.functional as F

    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    if bias_grad:
        am = am.detach().requires_grad_()
        ins.append(am)
    out = F.scaled_dot_product_attention(*ins[:3], attn_mask=am,
                                         dropout_p=p, scale=scale)
    return lambda: torch.autograd.grad(out, ins, dout, retain_graph=True)


def _opt_timing_cases(fa, device, dtype_name):
    """K1 (OPT eval), K2 (CLIP) and K3 (OPT training), in bf16 or fp16; in
    bf16 also K1 at Roberta's shape (the embedding mode's text tower) and
    K2 causal at the CLIP text tower's."""
    import torch

    dt = getattr(torch, dtype_name)
    cases = []
    k1 = [("flash_attention_allheads", 0, ""), ("fused_heads_attention", 2, "")]
    if dtype_name == "bfloat16":
        k1.append(("flash_attention_allheads", ROBERTA_CASE, "[roberta]"))
        k1.append(("fused_heads_attention", CLIP_TEXT_CASE,
                   CASE_TAGS[CLIP_TEXT_CASE]))
    for name, idx, tag in k1:
        (q, k, v), kw = kernel_inputs(idx, dt, device)
        s, h, d = q.shape[1:]
        am = float_mask(kw["kv_mask"], s, kw["causal"], None, dt)
        pairs = allowed_pairs(kw["kv_mask"], s, kw["causal"]) * h
        cases.append((
            f"{name} {tuple(q.shape)} causal={kw['causal']} "
            f"mask={CASES[idx][3]}", wkey(name + tag, dtype_name), {
                "kernel": partial(getattr(fa, name), q, k, v, **kw),
                "plain": partial(getattr(fa, KERNELS[name][0]), q, k, v,
                                 **kw),
                "library": _sdpa_fwd(*_bhsd(q, k, v), am)},
            4 * pairs * d, 4 * q.numel() * 2 + kw["kv_mask"].numel() * 4))
    args, kw = bwd_inputs(0, dt, device)
    q, k, v, mask, out, dout = args
    s, h, d = q.shape[1:]
    pairs = allowed_pairs(mask, s, True) * h
    # K3 as training runs it: from K1's row stats
    _, m, l = fa.flash_attention_allheads_stats(q, k, v, kv_mask=mask,
                                                causal=True)
    cases.append((
        f"flash_attention_allheads_bwd {tuple(q.shape)} causal from K1's "
        "stats",
        wkey("flash_attention_allheads_bwd", dtype_name), {
            "kernel": partial(fa.flash_attention_allheads_bwd, *args, **kw,
                              row_max=m, row_sum=l),
            "plain": partial(fa.allheads_attention_bwd_reference, *args,
                             **kw),
            "library": _sdpa_bwd(*_bhsd(q, k, v),
                                 float_mask(mask, s, True, None, dt),
                                 *_bhsd(dout))},
        10 * pairs * d, 8 * q.numel() * 2 + mask.numel() * 4))
    return cases


def _flash_timing_cases(fa, device, dtype_name, i=0):
    """K4 and K5 at FLASH_CASES[i] (T5-base's eval cross-attention; MPT's
    cross-attention; prefix tuning's 704 x 724), bf16 or fp16, phase 3's
    inputs."""
    import torch

    dt = getattr(torch, dtype_name)
    dims, causal, mask_kind = FLASH_CASES[i]
    q, k, v, mask, dout = flash_inputs(dims, mask_kind, dt, device, 200 + i)
    sq, h = dims[1], dims[3]
    kw = dict(kv_mask=mask, causal=causal)
    out = fa.flash_attention(q, k, v, **kw)
    qt, kt, vt, dot = _bhsd(q, k, v, dout)
    am = float_mask(mask, sq, causal, None, dt)
    pairs = allowed_pairs(mask, sq, causal) * h
    io_fwd = (2 * q.numel() + 2 * k.numel()) * 2 + mask.numel() * 4
    io_bwd = (4 * q.numel() + 4 * k.numel()) * 2 + mask.numel() * 4
    tag = FLASH_TAGS.get(i, "")
    label = f"{dims} causal={causal} mask={mask_kind}"
    return [
        (f"flash_attention {label}", wkey("flash_attention" + tag,
                                          dtype_name), {
            "kernel": partial(fa.flash_attention, q, k, v, **kw),
            "plain": partial(fa.flash_attention_reference, q, k, v, **kw),
            "library": _sdpa_fwd(qt, kt, vt, am)}, 4 * pairs * 64, io_fwd),
        (f"flash_attention_bwd {label}", wkey("flash_attention_bwd" + tag,
                                              dtype_name), {
            "kernel": partial(fa.flash_attention_bwd, q, k, v, mask, out,
                              dout, causal=causal),
            "plain": partial(fa.flash_attention_bwd_reference, q, k, v, mask,
                             out, dout, causal=causal),
            "library": _sdpa_bwd(qt, kt, vt, am, dot)},
         10 * pairs * 64, io_bwd)]


def _bias_timing_cases(fa, device, i, dtype_name):
    """K7 at BIAS_CASES[i] in eval (no dropout; not for the cross-attention,
    which is K4's in eval) and training (dropout), and its backward from
    K7's row stats: K9 at the encoders' shapes, K8 at the decoder's; bf16
    or fp16."""
    import torch

    dt = getattr(torch, dtype_name)
    tag, dims, causal, with_bias = BIAS_CASES[i]
    q, k, v, mask, bias, dout, seed = bias_inputs(dims, with_bias, dt,
                                                  device, 300 + i)
    sq, h = dims[1], dims[3]
    pairs = allowed_pairs(mask, sq, causal) * h
    bias_bytes = 0 if bias is None else bias.numel() * 2
    io_fwd = ((2 * q.numel() + 2 * k.numel()) * 2 + mask.numel() * 4
              + bias_bytes)
    # q, k, v, o, dO, mask and bias in; dq, dk, dv and dbias out
    io_bwd = ((4 * q.numel() + 4 * k.numel()) * 2 + mask.numel() * 4
              + 2 * bias_bytes)
    qt, kt, vt, dot = _bhsd(q, k, v, dout)
    am = float_mask(mask, sq, causal, bias, dt)
    shape = f"{tag} {dims} causal={causal} bias={with_bias}"
    # the 576-token encoder and the prefixed decoder have their own entries
    # in the kernels line
    at = {"enc576": "[576]", "t5prefix": "[t5-prefix]"}.get(tag, "")
    # the kernels take the bias as T5's stack hands it, its rows padded to
    # a multiple of 8 once a stack (the prefixed decoder's 148)
    kbias = None if bias is None else fa.padded_bias(bias)
    cases = []
    for rate in ((RATE,) if tag == "cross" else (0.0, RATE)):
        kw = dict(kv_mask=mask, causal=causal, scale=1.0, dropout_rate=rate,
                  dropout_seed=seed)
        cases.append((
            f"flash_attention_bias {shape} dropout={rate}",
            wkey("flash_attention_bias" + at, dtype_name), {
                "kernel": partial(fa.flash_attention_bias, q, k, v,
                                  bias=kbias, **kw),
                "plain": partial(fa.bias_attention_reference, q, k, v,
                                 bias=bias, **kw),
                "library": _sdpa_fwd(qt, kt, vt, am, rate, 1.0)},
            4 * pairs * 64, io_fwd))
    # K8/K9 as training runs it: from K7's row stats
    out, m, l = fa.flash_attention_bias_stats(
        q, k, v, bias=kbias, kv_mask=mask, causal=causal, scale=1.0,
        dropout_rate=RATE, dropout_seed=seed)
    bkw = dict(causal=causal, scale=1.0, dropout_rate=RATE,
               dropout_seed=seed)
    cases.append((
        f"flash_attention_bias_bwd {shape} dropout={RATE} from K7's stats",
        wkey({"enc": "flash_attention_bias_bwd[K9]",
              "enc576": "flash_attention_bias_bwd[K9,576]",
              "cross": "flash_attention_bias_bwd[K8,cross]",
              "t5prefix": "flash_attention_bias_bwd[t5-prefix]"}.get(
                  tag, "flash_attention_bias_bwd[K8]"), dtype_name), {
            "kernel": partial(fa.flash_attention_bias_bwd, q, k, v, mask,
                              None if bias is None else kbias[0], out, dout,
                              row_max=m, row_sum=l, **bkw),
            "plain": partial(fa.bias_attention_bwd_reference, q, k, v, mask,
                             bias, out, dout, **bkw),
            "library": _sdpa_bwd(qt, kt, vt, am, dot, RATE, 1.0,
                                 bias_grad=with_bias)},
        10 * pairs * 64, io_bwd + 2 * m.numel() * 4))
    return cases


def _blocked_timing_cases(fa, device, dtype_name):
    """K4 with its row stats, K6 and, for comparison, K5 at OPT-350M's
    training shape, bf16 or fp16, and K6 against K5 again at 1024 tokens.
    K6 and K5 compute the same gradient, so both are bounded by 10 * D
    FLOPs per allowed pair, K3's count; the bytes read q, k, v, dO, o, the
    mask (and K6 the stats) once and write dq, dk, dv once."""
    import torch

    dt = getattr(torch, dtype_name)
    dims, causal, _ = BLOCKED_CASES[0]
    cases = []
    # seed 400 at 2048: phase 3's inputs (blocked_inputs(0))
    for tokens, seed in ((2048, 400), (1024, 401)):
        dims = (dims[0], tokens, tokens, *dims[3:])
        q, k, v, mask, dout = flash_inputs((*dims, dims[3]), "hole", dt,
                                           device, seed)
        sq, h = dims[1], dims[3]
        out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask,
                                             causal=causal)
        qt, kt, vt, dot = _bhsd(q, k, v, dout)
        am = float_mask(mask, sq, causal, None, dt)
        pairs = allowed_pairs(mask, sq, causal) * h
        stats_bytes = 2 * m.numel() * 4
        io_fwd = 4 * q.numel() * 2 + mask.numel() * 4 + stats_bytes
        io_bwd = 8 * q.numel() * 2 + mask.numel() * 4
        shape = f"{dims} causal mask=hole"
        # the kernels line takes each name's first case: OPT-350M's shape
        tag = "" if tokens == 2048 else f"[{tokens}]"
        bwd_args = (q, k, v, mask, out, dout)
        if tokens == 2048:
            cases.append((
                f"flash_attention with stats {shape}",
                wkey("flash_attention[stats]", dtype_name), {
                    "kernel": partial(fa.flash_attention_stats, q, k, v,
                                      kv_mask=mask, causal=causal),
                    "plain": partial(fa.flash_attention_reference, q, k, v,
                                     kv_mask=mask, causal=causal,
                                     with_stats=True),
                    "library": _sdpa_fwd(qt, kt, vt, am)},
                4 * pairs * 64, io_fwd))
        cases += [
            (f"flash_attention_blocked_bwd {shape}",
             wkey(f"flash_attention_blocked_bwd{tag}", dtype_name), {
                 "kernel": partial(fa.flash_attention_blocked_bwd, *bwd_args,
                                   m, l, causal=causal),
                 "plain": partial(fa.flash_attention_blocked_bwd_reference,
                                  *bwd_args, m, l, causal=causal),
                 "library": _sdpa_bwd(qt, kt, vt, am, dot)},
             10 * pairs * 64, io_bwd + stats_bytes),
            (f"flash_attention_bwd {shape}",
             wkey(f"flash_attention_bwd[{tokens}]", dtype_name), {"kernel": partial(fa.flash_attention_bwd, *bwd_args,
                                causal=causal),
              "plain": partial(fa.flash_attention_bwd_reference, *bwd_args,
                               causal=causal),
              "library": _sdpa_bwd(qt, kt, vt, am, dot)},
             10 * pairs * 64, io_bwd)]
    return cases


def _head_dim_timing_cases(fa, device, d, s=640, blocked=True):
    """bf16, head dim d (80: OPT- and MPT-2.7B, 128: OPT-6.7B): K1 and K3
    at the training length s causal with a pad hole (4, s, 32, d), K4 and
    K5 at MPT's cross-attention (4, s x 64, 32, d); with ``blocked``, K4
    with its row stats and K6 at (4, 1024, 32, d) causal past K1's
    envelope."""
    import torch

    dt = torch.bfloat16
    cases = []
    b, h = 4, 32
    q, k, v, mask, dout = flash_inputs((b, s, s, h, h), "hole", dt, device,
                                       600 + d, d)
    kw = dict(kv_mask=mask, causal=True)
    out = fa.allheads_attention_reference(q, k, v, **kw)
    _, m, l = fa.flash_attention_allheads_stats(q, k, v, **kw)
    qt, kt, vt, dot = _bhsd(q, k, v, dout)
    am = float_mask(mask, s, True, None, dt)
    pairs = allowed_pairs(mask, s, True) * h
    label = f"{(b, s, h, d)} causal mask=hole"
    cases += [
        (f"flash_attention_allheads {label}",
         dkey("flash_attention_allheads", d), {
             "kernel": partial(fa.flash_attention_allheads, q, k, v, **kw),
             "plain": partial(fa.allheads_attention_reference, q, k, v,
                              **kw),
             "library": _sdpa_fwd(qt, kt, vt, am)},
         4 * pairs * d, 4 * q.numel() * 2 + mask.numel() * 4),
        (f"flash_attention_allheads_bwd {label}",
         dkey("flash_attention_allheads_bwd", d), {
             "kernel": partial(fa.flash_attention_allheads_bwd, q, k, v,
                               mask, out, dout, causal=True, row_max=m,
                               row_sum=l),
             "plain": partial(fa.allheads_attention_bwd_reference, q, k, v,
                              mask, out, dout, causal=True),
             "library": _sdpa_bwd(qt, kt, vt, am, dot)},
         10 * pairs * d, 8 * q.numel() * 2 + mask.numel() * 4)]
    dims = (b, s, 64, h, h)
    q, k, v, mask, dout = flash_inputs(dims, "gap_fully_masked", dt, device,
                                       700 + d, d)
    out = fa.flash_attention(q, k, v, kv_mask=mask)
    qt, kt, vt, dot = _bhsd(q, k, v, dout)
    am = float_mask(mask, s, False, None, dt)
    pairs = allowed_pairs(mask, s, False) * h
    label = f"{(b, s, 64, h, d)} cross mask=gap_fully_masked"
    cases += [
        (f"flash_attention {label}", dkey("flash_attention", d), {
            "kernel": partial(fa.flash_attention, q, k, v, kv_mask=mask),
            "plain": partial(fa.flash_attention_reference, q, k, v,
                             kv_mask=mask),
            "library": _sdpa_fwd(qt, kt, vt, am)},
         4 * pairs * d, (2 * q.numel() + 2 * k.numel()) * 2
         + mask.numel() * 4),
        (f"flash_attention_bwd {label}", dkey("flash_attention_bwd", d), {
            "kernel": partial(fa.flash_attention_bwd, q, k, v, mask, out,
                              dout),
            "plain": partial(fa.flash_attention_bwd_reference, q, k, v, mask,
                             out, dout),
            "library": _sdpa_bwd(qt, kt, vt, am, dot)},
         10 * pairs * d, (4 * q.numel() + 4 * k.numel()) * 2
         + mask.numel() * 4)]
    if not blocked:
        return cases
    s = 1024
    q, k, v, mask, dout = flash_inputs((b, s, s, h, h), "hole", dt, device,
                                       800 + d, d)
    out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask, causal=True)
    qt, kt, vt, dot = _bhsd(q, k, v, dout)
    am = float_mask(mask, s, True, None, dt)
    pairs = allowed_pairs(mask, s, True) * h
    stats_bytes = 2 * m.numel() * 4
    label = f"{(b, s, h, d)} causal mask=hole"
    cases += [
        (f"flash_attention with stats {label}",
         dkey("flash_attention[stats]", d), {
             "kernel": partial(fa.flash_attention_stats, q, k, v,
                               kv_mask=mask, causal=True),
             "plain": partial(fa.flash_attention_reference, q, k, v,
                              kv_mask=mask, causal=True, with_stats=True),
             "library": _sdpa_fwd(qt, kt, vt, am)},
         4 * pairs * d, 4 * q.numel() * 2 + mask.numel() * 4 + stats_bytes),
        (f"flash_attention_blocked_bwd {label}",
         dkey("flash_attention_blocked_bwd", d), {
             "kernel": partial(fa.flash_attention_blocked_bwd, q, k, v, mask,
                               out, dout, m, l, causal=True),
             "plain": partial(fa.flash_attention_blocked_bwd_reference, q, k,
                              v, mask, out, dout, m, l, causal=True),
             "library": _sdpa_bwd(qt, kt, vt, am, dot)},
         10 * pairs * d, 8 * q.numel() * 2 + mask.numel() * 4
         + stats_bytes)]
    return cases


def timing_cases(fa, device):
    """(label, kernel name, {"kernel", "plain", "library"} callables, FLOPs,
    bytes, dtype name) for every kernel at its main-path shapes, in bf16
    and in fp16; in bf16 also K1 at Roberta's shape, K7 with K9 at the
    embedding mode's 576-token encoder, K4 with K5 at MPT's cross-attention
    and at prefix tuning's 704 x 724, and K7 with K8 at T5's prefixed
    decoder; and in bf16 K1 and K3-K6 at head dims 80 and 128, K1 and
    K3-K5 at 80 first at BASELINE family 7's 205 tokens (phase 18, whose
    launches the kernels line gives them), then at 640 (family 4)."""
    cases = []
    for dtype_name in TC_DTYPES:
        bf16 = dtype_name == "bfloat16"
        got = _opt_timing_cases(fa, device, dtype_name)
        for i in (0,) + ((MPT_CROSS_CASE, PREFIX_CASE) if bf16 else ()):
            got += _flash_timing_cases(fa, device, dtype_name, i)
        # the encoder, decoder and cross shapes (and the 576 encoder and
        # the prefixed decoder)
        for i in (0, 1, 2) + ((ENC576_CASE, T5_PREFIX_CASE) if bf16
                              else ()):
            got += _bias_timing_cases(fa, device, i, dtype_name)
        got += _blocked_timing_cases(fa, device, dtype_name)
        if bf16:
            got += _head_dim_timing_cases(fa, device, 80, FAMILY7_TOKENS,
                                          blocked=False)
            for d in (80, 128):
                got += _head_dim_timing_cases(fa, device, d)
        cases += [c + (dtype_name,) for c in got]
    return cases


def time_kernels(fa, device):
    """Phase 8: {label: (kernel name, times, bound ms, bound_by)}."""
    rows = {}
    for label, name, fns, flops, nbytes, dtype_name in timing_cases(
            fa, device):
        times, n = median_ms(fns, device)
        bound, by = bound_ms(flops, nbytes)
        label = f"{label} {dtype_name}"
        rows[label] = (name, times, bound, by)
        print(f"[time] {label}: kernel {times['kernel']:.4f} ms, "
              f"plain {times['plain']:.4f} ms, library "
              f"{times['library']:.4f} ms (kernel / library "
              f"{times['kernel'] / times['library']:.3f}; medians of {n} "
              f"runs of {TIMING_RUN}, the plain version's of {PLAIN_RUN}); "
              f"bound {bound:.4f} ms ({by}: "
              f"{flops:.4g} FLOP, {nbytes:.4g} B)")
    return rows


def run_mpt_phase(cli, fa, device, micro):
    """Phase 13, BASELINE family 4 at MPT-2.7B's width and MPT_CUT_LAYERS
    of its layers, from cached tower features: the short run with its
    launch counts, the warm start, the fp32 and bf16 micro-steps. Returns
    the run's summary."""
    # BASELINE family 4 at MPT-2.7B's width (head dim 80) + Roberta + CLIP,
    # all, flamingo, from cached tower features: the cache build launches
    # the towers' K1 and K2, and no micro-step, eval step or generated
    # batch does; the self-attention takes K1 (every layer) and K3 (those
    # after the first cross layer), the cross layers' attention (640 x 64)
    # K4 and K5, the prefill's (512 x 64) K4; then a second start on the
    # same cache directory launches nothing
    layers, grad_layers = MPT_CUT_LAYERS, MPT_CUT_GRAD_LAYERS
    mpt_kernels = ("flash_attention_allheads", "flash_attention_allheads_bwd",
                   "flash_attention", "flash_attention_bwd")
    per = {"flash_attention_allheads": layers,
           "fused_heads_attention": 0, "flash_attention": MPT_CROSS}
    tag = f"mpt-2.7b flamingo ({layers} layers)"
    with ShapeTally(fa) as tally, tempfile.TemporaryDirectory() as log_dir, \
            tempfile.TemporaryDirectory() as cache_dir, \
            depth_cut("2.7b", layers):
        argv = with_flags(MPT_ARGV, neighbor_cache_dir=cache_dir)
        mpt = run_training(
            cli, fa, device, log_dir, argv, mpt_kernels,
            {"flash_attention_allheads": layers * micro,
             "flash_attention_allheads_bwd": grad_layers * micro,
             "fused_heads_attention": 0,
             "flash_attention": MPT_CROSS * micro,
             "flash_attention_bwd": MPT_CROSS * micro},
            tag=tag, per_eval=per, per_generate=per, updates=1,
            zero_first=(flamingo_zero,
                        "the cross layers and the memory reach the loss "
                        "only through branches scaled by tanh(gate), and "
                        "the gates start at 0"),
            cache_kernels=("flash_attention_allheads",
                           "fused_heads_attention"),
            warm_start=True)
    print(f"[{tag}] K4 launches by (Sq, Sk): {tally.flash}; K5: "
          f"{tally.flash_bwd}; K1-K5 by head dim: {dict(tally.dims)}")
    # the cross-attention at 640 x 64 in every micro-step and eval step,
    # at 512 x 64 in every prefill; K5 in the micro-steps alone; every LM
    # launch at head dim 80, the towers' (the cache build) at 64
    want = ({(640, 64): MPT_CROSS * (micro + mpt["eval_steps"]),
             (512, 64): MPT_CROSS * mpt["generated_batches"]},
            {(640, 64): MPT_CROSS * micro})
    if (tally.flash, tally.flash_bwd) != want:
        fail(f"MPT's K4/K5 launches by shape {tally.flash} / "
             f"{tally.flash_bwd}, expected {want}")
    lm_k1 = layers * (micro + mpt["eval_steps"] + mpt["generated_batches"])
    if (tally.dims[("flash_attention_allheads", 80)] != lm_k1
            or tally.dims[("flash_attention_allheads_bwd", 80)]
            != grad_layers * micro):
        fail(f"MPT-2.7B's K1/K3 launches at head dim 80 "
             f"{dict(tally.dims)}, expected K1 {lm_k1}")
    mpt["layers"] = layers
    mpt["launches_by_head_dim"] = {f"{n}[d{d}]": c
                                   for (n, d), c in tally.dims.items()}
    mpt["k4_by_shape"] = {f"{a}x{b}": n for (a, b), n in tally.flash.items()}
    mpt_step = {"flash_attention": MPT_CROSS,
                "flash_attention_bwd": MPT_CROSS,
                "flash_attention_allheads": layers,
                "flash_attention_allheads_bwd": grad_layers,
                "fused_heads_attention": 0}
    with depth_cut("2.7b", layers):
        for key, half in (("fp32_step", False), ("bf16_step", True)):
            mpt[key] = check_train_step(
                cli, fa, device, MPT_ARGV, mpt_kernels, tag, half=half,
                seeded=("gating",), per_step=mpt_step, cached=True)
    return mpt


def run_peft_phases(cli, fa, device, micro, lap=lambda phase: None):
    """Phases 12-14: BASELINE families 3, 4 (MPT-2.7B, cached), 5 (without
    its mesh) and 6, and config 2 with T5's decoder prefixes, each the short
    run through the CLI with its launch counts, then the micro-steps.
    Returns {"runs": {key: summary}, "launches": {kernels-line name: n}}."""
    runs, launches = {}, {}

    # phase 12: OPT-1.3B + Roberta, text_only, LoRA, --freeze_lm true;
    # 684 tokens (K1/K3), the prefill at 556 (K1)
    per = {"flash_attention_allheads": ROBERTA_LAYERS + OPT13_LAYERS,
           "fused_heads_attention": 0, "flash_attention": 0}
    with tempfile.TemporaryDirectory() as log_dir, \
            depth_cut("1.3b", OPT13_LAYERS):
        lora = run_training(
            cli, fa, device, log_dir, LORA_ARGV,
            ("flash_attention_allheads", "flash_attention_allheads_bwd"),
            {"flash_attention_allheads":
                 (ROBERTA_LAYERS + OPT13_LAYERS) * micro,
             "flash_attention_allheads_bwd": OPT13_LAYERS * micro,
             "fused_heads_attention": 0, "flash_attention": 0,
             "flash_attention_bwd": 0},
            tag="opt-1.3b lora", per_eval=per, per_generate=per, updates=1,
            idle=("text_embeddings.",),
            zero_first=(lambda n: "lora_a" in n,
                        "LoRA's A multiplies B, which starts at 0"))
    lora_step = {"flash_attention_allheads": ROBERTA_LAYERS + OPT13_LAYERS,
                 "flash_attention_allheads_bwd": OPT13_LAYERS}
    with depth_cut("1.3b", OPT13_LAYERS):
        for key, half in (("fp32_step", False), ("bf16_step", True)):
            lora[key] = check_train_step(
                cli, fa, device, LORA_ARGV,
                ("flash_attention_allheads", "flash_attention_allheads_bwd"),
                "opt-1.3b lora", half=half, seeded=("lora_b",),
                per_step=lora_step)
    lora["layers"] = OPT13_LAYERS
    runs["opt13b_lora_training"] = lora
    lap("12")

    runs["mpt27b_flamingo_training"] = run_mpt_phase(cli, fa, device, micro)
    lap("13")

    # phase 14a: OPT-125M + Roberta + CLIP, all, Laplacian, prefix: 704
    # queries against 20 + 704 keys take K4 and K5; the prefill K1
    per_eval = {"flash_attention_allheads": ROBERTA_LAYERS,
                "fused_heads_attention": CLIP_LAYERS,
                "flash_attention": OPT_LAYERS}
    per_gen = {"flash_attention_allheads": ROBERTA_LAYERS + OPT_LAYERS,
               "fused_heads_attention": CLIP_LAYERS, "flash_attention": 0}
    prefix_kernels = ("flash_attention_allheads", "fused_heads_attention",
                      "flash_attention", "flash_attention_bwd")
    with ShapeTally(fa) as tally, tempfile.TemporaryDirectory() as log_dir:
        prefix = run_training(
            cli, fa, device, log_dir, PREFIX_ARGV, prefix_kernels,
            {"flash_attention_allheads": ROBERTA_LAYERS * micro,
             "flash_attention_allheads_bwd": 0,
             "fused_heads_attention": CLIP_LAYERS * micro,
             "flash_attention": OPT_LAYERS * micro,
             "flash_attention_bwd": OPT_LAYERS * micro},
            tag="opt prefix", per_eval=per_eval, per_generate=per_gen,
            updates=1, idle=OPT_GRAPH_IDLE)
    print(f"[opt prefix] K4 launches by (Sq, Sk): {tally.flash}; K5: "
          f"{tally.flash_bwd}")
    if set(tally.flash) != {(704, 724)} or set(tally.flash_bwd) != {
            (704, 724)}:
        fail(f"prefix tuning's K4/K5 ran at {tally.flash} / "
             f"{tally.flash_bwd}, expected 704 x 724 only")
    launches["flash_attention[prefix]"] = tally.flash[(704, 724)]
    launches["flash_attention_bwd[prefix]"] = tally.flash_bwd[(704, 724)]
    prefix_step = {"flash_attention": OPT_LAYERS,
                   "flash_attention_bwd": OPT_LAYERS,
                   "flash_attention_allheads": ROBERTA_LAYERS,
                   "fused_heads_attention": CLIP_LAYERS,
                   "flash_attention_allheads_bwd": 0}
    prefix["fp32_step"] = check_train_step(
        cli, fa, device, PREFIX_ARGV, prefix_kernels, "opt prefix",
        per_step=prefix_step)
    prefix["bf16_step"] = check_train_step(
        cli, fa, device, PREFIX_ARGV, prefix_kernels, "opt prefix",
        half=True, per_step=prefix_step)
    runs["opt_prefix_training"] = prefix

    # phase 14b: OPT-125M + Roberta + CLIP, all, GCN, prompt: 20 + 704 =
    # 724 tokens take K1 and K3, the prefill at 20 + 576 = 596 K1
    per = {"flash_attention_allheads": ROBERTA_LAYERS + OPT_LAYERS,
           "fused_heads_attention": CLIP_LAYERS, "flash_attention": 0}
    with tempfile.TemporaryDirectory() as log_dir:
        prompt = run_training(
            cli, fa, device, log_dir, PROMPT_ARGV,
            ("flash_attention_allheads", "flash_attention_allheads_bwd",
             "fused_heads_attention"),
            {"flash_attention_allheads":
                 (ROBERTA_LAYERS + OPT_LAYERS) * micro,
             "flash_attention_allheads_bwd": OPT_LAYERS * micro,
             "flash_attention": 0,
             "fused_heads_attention": CLIP_LAYERS * micro},
            tag="opt prompt", per_eval=per, per_generate=per, updates=1,
            idle=OPT_GRAPH_IDLE)
    prompt_step = {"flash_attention_allheads": ROBERTA_LAYERS + OPT_LAYERS,
                   "flash_attention_allheads_bwd": OPT_LAYERS,
                   "fused_heads_attention": CLIP_LAYERS}
    for key, half in (("fp32_step", False), ("bf16_step", True)):
        prompt[key] = check_train_step(
            cli, fa, device, PROMPT_ARGV,
            ("flash_attention_allheads", "flash_attention_allheads_bwd"),
            "opt prompt", half=half, per_step=prompt_step)
    runs["opt_prompt_training"] = prompt

    # phase 14c: BASELINE config 2 with T5's decoder prefixes: 128 queries
    # against 20 + 128 keys with a ragged bias take K7 and K8
    emb_eval = {"flash_attention_allheads": ROBERTA_LAYERS,
                "fused_heads_attention": CLIP_LAYERS,
                "flash_attention_bias": 2 * T5_LAYERS,
                "flash_attention": T5_LAYERS}
    emb_gen = {"flash_attention_allheads": ROBERTA_LAYERS,
               "fused_heads_attention": CLIP_LAYERS,
               "flash_attention_bias": T5_LAYERS, "flash_attention": 0}
    with ShapeTally(fa) as tally, tempfile.TemporaryDirectory() as log_dir:
        t5p = run_training(
            cli, fa, device, log_dir, T5_PREFIX_ARGV,
            ("flash_attention_allheads", "fused_heads_attention",
             "flash_attention_bias", "flash_attention_bias_bwd"),
            {"flash_attention_allheads": ROBERTA_LAYERS * micro,
             "fused_heads_attention": CLIP_LAYERS * micro,
             "flash_attention_bias": 3 * T5_LAYERS * micro,
             "flash_attention_bias_bwd": 3 * T5_LAYERS * micro,
             "flash_attention_allheads_bwd": 0, "flash_attention": 0,
             "flash_attention_bwd": 0},
            tag="t5 prefix", per_eval=emb_eval, per_generate=emb_gen,
            updates=1)
    print(f"[t5 prefix] K7 launches by (Sq, Sk): {tally.fwd}; K8/K9: "
          f"{tally.bwd}")
    dec = (128, 128 + VIRTUAL)
    # training: 12 a micro-step; each eval step (val before, val after,
    # test) 12; generation none (no prefix, and one query a step)
    evals = t5p["eval_steps"]
    if tally.fwd.get(dec) != T5_LAYERS * (micro + evals) or tally.bwd.get(
            dec) != T5_LAYERS * micro or (128, 128) in tally.fwd:
        fail(f"T5's prefixed decoder launched K7 {tally.fwd} and K8 "
             f"{tally.bwd}, expected {dec} {T5_LAYERS * (micro + evals)} "
             f"and {T5_LAYERS * micro} times")
    launches["flash_attention_bias[t5-prefix]"] = tally.fwd[dec]
    launches["flash_attention_bias_bwd[t5-prefix]"] = tally.bwd[dec]
    t5p["k7_by_shape"] = {f"{a}x{b}": n for (a, b), n in tally.fwd.items()}
    t5p["bf16_step"] = check_train_step(
        cli, fa, device, T5_PREFIX_ARGV,
        ("flash_attention_bias", "flash_attention_bias_bwd"), "t5 prefix",
        half=True,
        per_step={"flash_attention": T5_LAYERS,
                  "flash_attention_bwd": T5_LAYERS,
                  "flash_attention_bias": 2 * T5_LAYERS,
                  "flash_attention_bias_bwd": 2 * T5_LAYERS})
    runs["t5_prefix_training"] = t5p
    lap("14")
    return {"runs": runs, "launches": launches}


def live_pooled(model, batch, device):
    """The towers' pooled features of a live batch, keyed as the neighbour
    cache serves them: ``model.pool_text`` and ``model.pool_images`` on the
    batch's raw ids and pixels, (B, N, hidden) fp32 on the card."""
    import numpy as np
    import torch

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def images(px, valid):
        b, nv = px.shape[:2]
        return model.pool_images(dev(px).flatten(0, 1),
                                 dev(valid).flatten(0, 1)).float().reshape(
                                     b, nv, -1)

    out = {}
    if "neighbor_input_ids" in batch and model.config.needs_text_tower:
        ids = dev(batch["neighbor_input_ids"])
        out["neighbor_text_pooled"] = model.pool_text(
            ids.flatten(0, 1), dev(batch["neighbor_attention_mask"]).flatten(
                0, 1)).float().reshape(ids.shape[0], ids.shape[1], -1)
    if "neighbor_images" in batch and model.config.needs_vision_tower:
        out["neighbor_image_pooled"] = images(
            batch["neighbor_images"], batch["neighbor_images_pos_ids"] > 0)
    if "images" in batch and model.config.needs_vision_tower:
        px = batch["images"]
        out["images_pooled"] = images(
            px, batch.get("images_valid", np.ones(px.shape[:2], np.int32)))
    return out


def check_cached_features(model, live, cached, tag, device):
    """Each pooled array the cache served for a batch against the towers
    run live on the same samples: at most phase 3's bf16 atol of its
    largest entry away, and nearer to each sample's own live features than
    to its neighbour's (the batch rolled by one), so that a stale, zeroed
    or misaligned cache fails. Returns {key: (error, rolled error, scale)}."""
    import torch

    want = live_pooled(model, live, device)
    keys = sorted(k for k in cached if k.endswith("_pooled"))
    if sorted(want) != keys:
        fail(f"{tag}: the cache served {keys}, the live towers give "
             f"{sorted(want)}")
    atol = TOLERANCES["bfloat16"][0]
    report = {}
    for key in keys:
        got = torch.from_numpy(cached[key]).to(device)
        ref = want[key]
        if got.shape != ref.shape:
            fail(f"{tag}: cached {key} {tuple(got.shape)}, live "
                 f"{tuple(ref.shape)}")
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        rolled = float((got.roll(1, 0) - ref).abs().max())
        report[key] = (err, rolled, scale)
        print(f"[{tag}] cached {key} {tuple(got.shape)} against the live "
              f"towers: max abs {err:.3e} of {scale:.3e} (atol {atol:g} of "
              f"it), one sample over {rolled:.3e}")
        if not (math.isfinite(err) and err <= atol * scale and err < rolled):
            fail(f"{tag}: cached {key} disagrees with the live towers "
                 f"({err:.3e}; one sample over {rolled:.3e})")
    return report


def check_cached_loss(cli, fa, device, argv, tag, n=4):
    """One fixed batch (the first n samples of the train split) through the
    same seeded bf16 model in eval mode, from its raw neighbours and from
    the neighbour cache's features: the cached pooled features against the
    towers run live on the batch (``check_cached_features``), the cached
    forward launches no K2 (and no Roberta K1) where the live one launches
    them, and the two losses agree at phase 3's bf16 tolerance."""
    import torch
    from mmgl_tpu_torch.models.factory import build_model
    from mmgl_tpu_torch.train.steps import losses_of

    args, _ = cli.parse_cli(argv)
    args.decoder_only = "t5" not in args.model_name_or_path
    tokenizer = cli.get_tokenizer(args.tokenizer_path)
    train_ds = cli.setup_data(args, tokenizer)[0]
    model, _ = build_model(args, device, vocab_size=tokenizer.vocab_size,
                           tokenizer=tokenizer)
    batches = {"live": next(iter(cli.PrefetchLoader(train_ds, batch_size=n,
                                                    num_workers=1))),
               "cached": cached_batch(cli, model, train_ds, n)}
    features = check_cached_features(model, batches["live"],
                                     batches["cached"], tag, device)
    got = {}
    for which, batch in batches.items():
        reset_launches(fa)
        with torch.no_grad():
            out = model.eval()(batch)
            loss = float(losses_of(out, args.decoder_only,
                                   args.max_input_length,
                                   tokenizer.pad_token_id)[0])
        got[which] = (loss, {k: getattr(fa, k).launches for k in (
            "flash_attention_allheads", "fused_heads_attention")})
    atol, rtol = TOLERANCES["bfloat16"]
    live, cached = got["live"][0], got["cached"][0]
    print(f"[{tag}] bf16 eval loss of one batch of {n}: cached {cached:.7f}"
          f", live {live:.7f} (atol {atol:g}, rtol {rtol:g}); launches "
          f"cached {got['cached'][1]}, live {got['live'][1]}")
    if not got["live"][1]["fused_heads_attention"] or got["cached"][1][
            "fused_heads_attention"] or not (
            math.isfinite(cached) and abs(cached - live)
            <= atol + rtol * abs(live)):
        fail(f"{tag}: the cached forward's loss or launches disagree with "
             "the live one's")
    del model
    return {"loss_cached": cached, "loss_live": live,
            "launches": {k: v[1] for k, v in got.items()},
            "pooled_max_abs_err": features}


def run_opt67_phase(cli, fa, device):
    """Phase 16: OPT-6.7B's test pass (head dim 128) at OPT67_LAYERS of its
    32 layers, full width, with its launch counts. Returns its summary and
    {kernels-line name: launches} at head dim 128."""
    with ShapeTally(fa) as tally, depth_cut("6.7b", OPT67_LAYERS):
        _, results, launches, rate, peak = run_test_pass(
            cli, fa, device, OPT67_TEST_ARGV, OPT_TEST_KERNELS,
            {"flash_attention_allheads": OPT67_LAYERS,
             "fused_heads_attention": CLIP_LAYERS},
            {"flash_attention_allheads": OPT67_LAYERS,
             "fused_heads_attention": CLIP_LAYERS}, tag="opt-6.7b")
    print(f"[opt-6.7b test] K1-K5 launches by head dim: {dict(tally.dims)}")
    k1_128 = tally.dims[("flash_attention_allheads", 128)]
    if k1_128 != launches["flash_attention_allheads"] or not k1_128:
        fail(f"OPT-6.7B's K1 launches by head dim {dict(tally.dims)}")
    gc.collect()
    return ({"sections_per_s": rate, "peak_bytes": peak,
             "test_loss": results["loss"], "launches": launches,
             "launches_by_head_dim": {f"{n}[d{d}]": c for (n, d), c
                                      in tally.dims.items()},
             "layers": OPT67_LAYERS},
            {dkey(n, d): c for (n, d), c in tally.dims.items() if d == 128})


def run_cached_phases(cli, fa, device, micro, opt_live, emb_live):
    """Phase 15: the main path (BASELINE config 1: OPT-125M + CLIP, raw
    all) and config 2 (T5-base + Roberta + CLIP, section_all, embedding)
    trained from the neighbour cache through the CLI, 4 updates each: the
    cache build launches the towers (config 1 CLIP's K2 alone, config 2
    Roberta's K1 and K2), no update, eval step or generated batch does;
    each config's cached pooled features and bf16 loss on one batch against
    the live ones (``check_cached_loss``). Its
    update seconds are printed beside the uncached runs' of phases 5 and
    10 (``opt_live``, ``emb_live``): a reading, not a claim."""
    runs = {}
    no_towers = {"fused_heads_attention": 0}
    with tempfile.TemporaryDirectory() as log_dir:
        opt = run_training(
            cli, fa, device, log_dir, OPT_CACHED_ARGV,
            ("flash_attention_allheads", "flash_attention_allheads_bwd"),
            {"flash_attention_allheads": OPT_LAYERS * micro,
             "flash_attention_allheads_bwd": OPT_LAYERS * micro,
             **no_towers},
            tag="opt cached",
            per_eval={"flash_attention_allheads": OPT_LAYERS, **no_towers},
            per_generate={"flash_attention_allheads": OPT_LAYERS,
                          **no_towers},
            cache_kernels=("fused_heads_attention",))
    opt["fixed_batch"] = check_cached_loss(cli, fa, device, OPT_CACHED_ARGV,
                                           "opt cached")
    runs["opt_cached_training"] = opt
    no_towers["flash_attention_allheads"] = 0
    with tempfile.TemporaryDirectory() as log_dir:
        emb = run_training(
            cli, fa, device, log_dir, T5_EMB_CACHED_ARGV,
            ("flash_attention_bias", "flash_attention_bias_bwd"),
            {"flash_attention_bias": 3 * T5_LAYERS * micro,
             "flash_attention_bias_bwd": 3 * T5_LAYERS * micro,
             **no_towers},
            tag="t5 emb cached",
            per_eval={"flash_attention_bias": 2 * T5_LAYERS,
                      "flash_attention": T5_LAYERS, **no_towers},
            per_generate={"flash_attention_bias": T5_LAYERS, **no_towers},
            cache_kernels=("flash_attention_allheads",
                           "fused_heads_attention"))
    emb["fixed_batch"] = check_cached_loss(cli, fa, device,
                                           T5_EMB_CACHED_ARGV,
                                           "t5 emb cached")
    runs["t5_embedding_cached_training"] = emb
    for tag, live, got in (("config 1 (OPT-125M raw all)", opt_live, opt),
                           ("config 2 (T5-base embedding)", emb_live, emb)):
        print(f"[cached] {tag}: update seconds cached "
              f"{[round(x, 4) for x in got['update_seconds']]} "
              f"({got['sections_per_s']:.3f} sections/s), uncached "
              f"{[round(x, 4) for x in live['update_seconds']]} "
              f"({live['sections_per_s']:.3f} sections/s); peak "
              f"{got['peak_bytes'] / 2**30:.3f} against "
              f"{live['peak_bytes'] / 2**30:.3f} GiB")
    return runs


# ---- phases 17 and 18: pretrained checkpoints -------------------------------

def _hf_arrays(rng, shapes, dtype):
    """{HF name: seeded array}: matrices, tables and biases normal(0, 0.02)
    (HF's init std), LayerNorm weights 1 + normal(0, 0.02), so that a
    weight and a bias, or two layers, cannot be swapped unseen."""
    out = {}
    for name, shape in shapes.items():
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if "norm" in name and name.endswith(".weight"):
            x += np.float32(1.0)
        out[name] = x.astype(dtype)
    return out


def _opt125m_shapes():
    """OPT-125M's names and shapes as HF's OPTForCausalLM saves them."""
    h, f, v = 768, 3072, 50272
    pre = "model.decoder."
    shapes = {pre + "embed_tokens.weight": (v, h),
              pre + "embed_positions.weight": (2050, h),   # 2048 + offset 2
              pre + "final_layer_norm.weight": (h,),
              pre + "final_layer_norm.bias": (h,)}
    for i in range(OPT_LAYERS):
        layer = f"{pre}layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{layer}self_attn.{proj}.weight"] = (h, h)
            shapes[f"{layer}self_attn.{proj}.bias"] = (h,)
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            shapes[f"{layer}{norm}.weight"] = (h,)
            shapes[f"{layer}{norm}.bias"] = (h,)
        shapes.update({f"{layer}fc1.weight": (f, h), f"{layer}fc1.bias": (f,),
                       f"{layer}fc2.weight": (h, f), f"{layer}fc2.bias": (h,)})
    return shapes


def _clip_tower_layers(shapes, tower, h, f):
    for i in range(CLIP_LAYERS):
        layer = f"{tower}.encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{layer}self_attn.{proj}.weight"] = (h, h)
            shapes[f"{layer}self_attn.{proj}.bias"] = (h,)
        for norm in ("layer_norm1", "layer_norm2"):
            shapes[f"{layer}{norm}.weight"] = (h,)
            shapes[f"{layer}{norm}.bias"] = (h,)
        shapes.update({f"{layer}mlp.fc1.weight": (f, h),
                       f"{layer}mlp.fc1.bias": (f,),
                       f"{layer}mlp.fc2.weight": (h, f),
                       f"{layer}mlp.fc2.bias": (h,)})


def _clip_vitb16_shapes():
    """CLIP ViT-B/16's CLIPModel as HF saves it: the vision tower (768
    wide, 16 px patches, 197 positions), the text tower (512 wide,
    vocabulary 49408, 77 positions), each 12 layers, and the projections
    MMGL does not use."""
    v = "vision_model."
    shapes = {v + "embeddings.class_embedding": (768,),
              v + "embeddings.patch_embedding.weight": (768, 3, 16, 16),
              v + "embeddings.position_embedding.weight": (197, 768)}
    for norm in ("pre_layrnorm", "post_layernorm"):   # HF's typo'd name
        shapes[f"{v}{norm}.weight"] = (768,)
        shapes[f"{v}{norm}.bias"] = (768,)
    _clip_tower_layers(shapes, "vision_model", 768, 3072)
    t = "text_model."
    shapes.update({t + "embeddings.token_embedding.weight": (49408, 512),
                   t + "embeddings.position_embedding.weight": (77, 512),
                   t + "final_layer_norm.weight": (512,),
                   t + "final_layer_norm.bias": (512,)})
    _clip_tower_layers(shapes, "text_model", 512, 2048)
    shapes.update({"visual_projection.weight": (512, 768),
                   "text_projection.weight": (512, 512)})
    return shapes


_SAFETENSORS_DTYPES = {"float32": "F32", "float16": "F16"}


def write_safetensors(path: str, arrays) -> None:
    """The safetensors format: an 8-byte little-endian header length, a
    JSON header of dtype, shape and byte offsets (padded with spaces to 8
    bytes), then the little-endian buffers in order."""
    header, offset = {}, 0
    for name, arr in arrays.items():
        header[name] = {"dtype": _SAFETENSORS_DTYPES[arr.dtype.name],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for arr in arrays.values():
            f.write(memoryview(np.ascontiguousarray(arr)).cast("B"))


def write_checkpoints(root: str):
    """Phase 17's HF-layout checkpoints under ``root``, from seeded numpy
    arrays: OPT-125M as pytorch_model.bin in fp16 (HF's storage for OPT;
    lm_head.weight, the tied embedding, saved beside it as HF does) and
    CLIP ViT-B/16 as a CLIPModel's model.safetensors in fp32. Returns
    {directory: {HF name: array}}."""
    import torch

    rng = np.random.default_rng(17)
    opt = _hf_arrays(rng, _opt125m_shapes(), np.float16)
    os.makedirs(os.path.join(root, CKPT_OPT))
    tensors = {k: torch.from_numpy(v) for k, v in opt.items()}
    tensors["lm_head.weight"] = tensors["model.decoder.embed_tokens.weight"]
    torch.save(tensors, os.path.join(root, CKPT_OPT, "pytorch_model.bin"))
    clip = _hf_arrays(rng, _clip_vitb16_shapes(), np.float32)
    clip["logit_scale"] = np.array(2.6592, np.float32)
    os.makedirs(os.path.join(root, CKPT_CLIP))
    write_safetensors(os.path.join(root, CKPT_CLIP, "model.safetensors"),
                      clip)
    return {CKPT_OPT: opt, CKPT_CLIP: clip}


def port_name(hf_name: str):
    """(the port's parameter name, a function from the file's tensor to the
    parameter's) for an HF name, or None where MMGL has no parameter (the
    tied head, CLIP's projections and logit scale). The port's Linear
    holds HF's (out, in) weight as it is (the flax kernel in between is its
    transpose both ways); the patch conv (out, 3, p, p) becomes the
    flattened-patch Linear over the (p, p, 3) order."""
    same = lambda w: w
    if hf_name.startswith("model.decoder."):
        return "lm.decoder." + hf_name[len("model.decoder."):], same
    tower = hf_name.split(".")[0]
    if tower not in ("vision_model", "text_model"):
        return None
    rest = hf_name[len(tower) + 1:]
    prefix = "visual_model." if tower == "vision_model" else "text_model."
    if rest == "embeddings.patch_embedding.weight":
        return (prefix + rest,
                lambda w: w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))
    for old, new in (("embeddings.token_embedding", "embeddings_token"),
                     ("pre_layrnorm", "pre_layernorm"),
                     ("self_attn.q_proj", "attention.query"),
                     ("self_attn.k_proj", "attention.key"),
                     ("self_attn.v_proj", "attention.value"),
                     ("self_attn.out_proj", "attention.out"),
                     ("layer_norm1", "norm1"), ("layer_norm2", "norm2"),
                     ("mlp.", "")):
        rest = rest.replace(old, new)
    if tower == "text_model":
        rest = rest.replace("embeddings.position_embedding",
                            "embeddings_position")
    return prefix + rest, same


def check_imported(model, files, tag, prefixes):
    """Every parameter of the model under ``prefixes`` (MPT's cross layers
    aside, which keep their init) equals its file tensor under HF's names,
    bit for bit (fp16 files widened to the fp32 parameters); returns the
    count."""
    import torch

    params = dict(model.named_parameters())
    matched = set()
    for arrays in files.values():
        for hf_name, arr in arrays.items():
            mapped = port_name(hf_name)
            if mapped is None or not mapped[0].startswith(prefixes):
                continue
            name, transform = mapped
            got = params.get(name)
            want = transform(torch.from_numpy(np.asarray(arr)))
            if got is None or not torch.equal(
                    got.detach(), want.to(got.device, got.dtype)):
                fail(f"{tag}: {name} does not hold the file's {hf_name}")
            matched.add(name)
    owed = {n for n in params if n.startswith(prefixes)
            and ".neighbor_layers." not in n}
    if owed != matched:
        fail(f"{tag}: parameters not imported {sorted(owed - matched)[:5]}")
    print(f"[{tag}] {len(matched)} parameters under {prefixes} equal their "
          "file tensors bit for bit")
    return len(matched)


def run_checkpoint_phase(cli, fa, device, files, seeded_loss):
    """Phase 17: the main path's test pass from the HF-layout checkpoints
    (``files``, in the working directory): the imported parameters, the
    launch counts, a finite loss that is not the seeded model's
    (``seeded_loss``, phase 4's), and the fp32 eval step card vs CPU."""
    per = {"flash_attention_allheads": OPT_LAYERS,
           "fused_heads_attention": CLIP_LAYERS}
    test, results, launches, rate, peak = run_test_pass(
        cli, fa, device, OPT_CKPT_TEST_ARGV, OPT_TEST_KERNELS, per, per,
        tag="opt ckpt")
    imported = check_imported(test.model, files, "opt ckpt",
                              ("lm.", "visual_model."))
    loss = results["loss"]
    print(f"[opt ckpt] test loss {loss:.6f} from the checkpoints, "
          f"{seeded_loss:.6f} from the seeded weights (phase 4)")
    if not (math.isfinite(loss) and abs(loss - seeded_loss) > 1e-3):
        fail("the test loss from the checkpoints is not finite or is the "
             "seeded model's")
    fp32 = check_model_fp32(cli, fa, test, device, OPT_CKPT_TEST_ARGV,
                            "opt ckpt")
    del test
    gc.collect()
    return {"sections_per_s": rate, "peak_bytes": peak, "test_loss": loss,
            "seeded_test_loss": seeded_loss, "launches": launches,
            "imported_parameters": imported, "fp32_eval": fp32}


def run_family7_phase(cli, fa, device, micro, files):
    """Phase 18: BASELINE family 7 at MPT-2.7B's width and MPT_CUT_LAYERS
    of its layers with the imported CLIP text and vision towers, uncached,
    the short run with its launch counts by shape, then its fp32
    micro-step card vs CPU and its bf16 micro-step with every launch held
    against its plain version on the same inputs.
    Returns the run's summary and {kernels-line name: launches}: K2 at the
    text tower's shape, K1 and K3-K5 at head dim 80."""
    step = {"flash_attention_allheads": MPT_CUT_LAYERS,
            "flash_attention_allheads_bwd": MPT_CUT_GRAD_LAYERS,
            "fused_heads_attention": 2 * CLIP_LAYERS,
            "flash_attention": MPT_CROSS, "flash_attention_bwd": MPT_CROSS}
    per_pass = {"flash_attention_allheads": MPT_CUT_LAYERS,
                "fused_heads_attention": 2 * CLIP_LAYERS,
                "flash_attention": MPT_CROSS,
                "flash_attention_allheads_bwd": 0}
    imported = []
    with ShapeTally(fa) as tally, tempfile.TemporaryDirectory() as log_dir, \
            depth_cut("2.7b", MPT_CUT_LAYERS):
        run = run_training(
            cli, fa, device, log_dir, FAMILY7_ARGV, tuple(step),
            {n: c * micro for n, c in step.items()},
            tag="mpt-2.7b cliptext", per_eval=per_pass,
            per_generate=per_pass, updates=1,
            zero_first=(flamingo_zero,
                        "the cross layers and the memory reach the loss "
                        "only through branches scaled by tanh(gate), and "
                        "the gates start at 0"),
            on_build=lambda model: imported.append(check_imported(
                model, files, "mpt-2.7b cliptext",
                ("text_model.", "visual_model."))))
    evals, gens = run["eval_steps"], run["generated_batches"]
    passes = micro + evals + gens
    print(f"[mpt-2.7b cliptext] K2 launches by (S, causal): "
          f"{dict(tally.fused)}; K4 by (Sq, Sk): {tally.flash}; K5: "
          f"{tally.flash_bwd}; K1-K5 by head dim: {dict(tally.dims)}")
    # the text tower's 12 causal layers and the vision tower's 12 in every
    # micro-step, eval step and prefill; the cross-attention at 205 x 64
    # (77 + 128 tokens against 16 neighbours x 4) in the micro-steps and
    # eval steps, at 77 x 64 in the prefills; the LM at head dim 80
    want = ({(FAMILY7_TEXT, True): CLIP_LAYERS * passes,
             (197, False): CLIP_LAYERS * passes},
            {(FAMILY7_TOKENS, 64): MPT_CROSS * (micro + evals),
             (FAMILY7_TEXT, 64): MPT_CROSS * gens},
            {(FAMILY7_TOKENS, 64): MPT_CROSS * micro})
    if (dict(tally.fused), tally.flash, tally.flash_bwd) != want:
        fail(f"family 7's K2/K4/K5 launches by shape {dict(tally.fused)} / "
             f"{tally.flash} / {tally.flash_bwd}, expected {want}")
    if (tally.dims[("flash_attention_allheads", 80)]
            != MPT_CUT_LAYERS * passes
            or tally.dims[("flash_attention_allheads_bwd", 80)]
            != MPT_CUT_GRAD_LAYERS * micro):
        fail(f"family 7's K1/K3 launches at head dim 80 {dict(tally.dims)}")
    run["imported_parameters"] = imported
    run["k2_by_shape"] = {f"{s}{'c' if c else ''}": n
                          for (s, c), n in tally.fused.items()}
    run["k4_by_shape"] = {f"{a}x{b}": n for (a, b), n in tally.flash.items()}
    run["layers"] = MPT_CUT_LAYERS
    with depth_cut("2.7b", MPT_CUT_LAYERS):
        for key, half in (("fp32_step", False), ("bf16_step", True)):
            run[key] = check_train_step(
                cli, fa, device, FAMILY7_ARGV, tuple(step),
                f"mpt-2.7b cliptext ({MPT_CUT_LAYERS} layers)", half=half,
                seeded=("gating",), per_step=step)
            run[key]["layers"] = MPT_CUT_LAYERS
    gc.collect()
    launches = {dkey(n, 80): tally.dims[(n, 80)] for n in (
        "flash_attention_allheads", "flash_attention_allheads_bwd",
        "flash_attention", "flash_attention_bwd")}
    launches["fused_heads_attention[clip-text]"] = tally.fused[
        (FAMILY7_TEXT, True)]
    return run, launches


def _same(a: float, b: float, dtype_name: str = "bfloat16") -> bool:
    """a within phase 3's tolerance for ``dtype_name`` of b."""
    atol, rtol = TOLERANCES[dtype_name]
    return abs(a - b) <= atol + rtol * abs(b)


def run_remat_phase(cli, fa, device, micro, lora):
    """Phase 19: BASELINE family 3 (phase 12's OPT-1.3B + Roberta + LoRA,
    --freeze_lm true, 684 tokens) under --remat true, as the JAX package's
    bench runs it: the short run through the CLI, with the same seed and
    batch as phase 12 (``lora``, its summary). Every micro-step launches K1
    twice a layer of the LM (the forward and the recompute) beside
    Roberta's 12, and K3 once a layer; its update's loss and gradient norm
    equal phase 12's at phase 3's bf16 tolerance; its peak is printed beside
    phase 12's. Then its bf16 micro-step, every launch (the recomputed ones
    too) held against its plain version, LoRA's B seeded."""
    per = {"flash_attention_allheads": ROBERTA_LAYERS + OPT13_LAYERS,
           "fused_heads_attention": 0, "flash_attention": 0}
    with tempfile.TemporaryDirectory() as log_dir, \
            depth_cut("1.3b", OPT13_LAYERS):
        run = run_training(
            cli, fa, device, log_dir, LORA_REMAT_ARGV,
            ("flash_attention_allheads", "flash_attention_allheads_bwd"),
            {"flash_attention_allheads":
                 (ROBERTA_LAYERS + 2 * OPT13_LAYERS) * micro,
             "flash_attention_allheads_bwd": OPT13_LAYERS * micro,
             "fused_heads_attention": 0, "flash_attention": 0,
             "flash_attention_bwd": 0},
            tag="opt-1.3b lora remat", per_eval=per, per_generate=per,
            updates=1, idle=("text_embeddings.",),
            zero_first=(lambda n: "lora_a" in n,
                        "LoRA's A multiplies B, which starts at 0"))
    diff = {k: abs(run[k][0] - lora[k][0]) for k in ("losses", "grad_norms")}
    print(f"[opt-1.3b lora remat] update 1 against phase 12's: loss "
          f"{run['losses'][0]:.7f} vs {lora['losses'][0]:.7f}, grad_norm "
          f"{run['grad_norms'][0]:.7f} vs {lora['grad_norms'][0]:.7f}, "
          f"differences {diff}; peak {run['peak_bytes'] / 2**30:.3f} GiB "
          f"against phase 12's {lora['peak_bytes'] / 2**30:.3f} GiB")
    if not all(_same(run[k][0], lora[k][0]) for k in diff):
        fail("family 3 under --remat does not reproduce phase 12's update")
    run["phase12"] = {"loss": lora["losses"][0],
                      "grad_norm": lora["grad_norms"][0],
                      "peak_bytes": lora["peak_bytes"], "difference": diff}
    with depth_cut("1.3b", OPT13_LAYERS):
        run["bf16_step"] = check_train_step(
            cli, fa, device, LORA_REMAT_ARGV,
            ("flash_attention_allheads", "flash_attention_allheads_bwd"),
            "opt-1.3b lora remat", half=True, seeded=("lora_b",),
            per_step={"flash_attention_allheads":
                          ROBERTA_LAYERS + 2 * OPT13_LAYERS,
                      "flash_attention_allheads_bwd": OPT13_LAYERS})
    run["layers"] = OPT13_LAYERS
    gc.collect()
    return run


def run_opt67_train_phase(cli, fa, device, micro):
    """Phase 20: OPT-6.7B + LoRA trained as scripts/probe_67b.py sets it
    (--remat true --chunked_ce 8, bf16 parameters, section_only), at
    OPT67_LAYERS of its 32 layers, full width: the short run through the
    CLI, every micro-step launching K1 twice a layer and K3 once at head
    dim 128 on the tensor-core bodies (counted by head dim); every eval
    step and generated batch K1 once a layer. Then its bf16 micro-step,
    every launch held against its plain version, and the same sample's
    loss through the materialised logits against the chunked one. Returns
    its summary and {kernels-line name: launches} at head dim 128."""
    k1, k3 = "flash_attention_allheads", "flash_attention_allheads_bwd"
    per = {k1: OPT67_LAYERS, "fused_heads_attention": 0,
           "flash_attention": 0}
    with depth_cut("6.7b", OPT67_LAYERS):
        with ShapeTally(fa) as tally, \
                tempfile.TemporaryDirectory() as log_dir:
            run = run_training(
                cli, fa, device, log_dir, OPT67_TRAIN_ARGV, (k1, k3),
                {k1: 2 * OPT67_LAYERS * micro, k3: OPT67_LAYERS * micro,
                 "fused_heads_attention": 0, "flash_attention": 0,
                 "flash_attention_bwd": 0},
                tag="opt-6.7b lora", per_eval=per, per_generate=per,
                updates=1,
                zero_first=(lambda n: "lora_a" in n,
                            "LoRA's A multiplies B, which starts at 0"))
        passes = run["eval_steps"] + run["generated_batches"]
        dims = {f"{n}[d{d}]": c for (n, d), c in tally.dims.items()}
        print(f"[opt-6.7b lora] K1-K5 launches by head dim: {dims}")
        if (tally.dims[(k1, 128)] != OPT67_LAYERS * (2 * micro + passes)
                or tally.dims[(k3, 128)] != OPT67_LAYERS * micro
                or set(d for _, d in tally.dims) != {128}):
            fail(f"OPT-6.7B's launches by head dim {dims}")
        run["launches_by_head_dim"] = dims
        run["layers"] = OPT67_LAYERS
        run["bf16_step"] = check_train_step(
            cli, fa, device, OPT67_TRAIN_ARGV, (k1, k3),
            f"opt-6.7b lora ({OPT67_LAYERS} layers)", half=True,
            seeded=("lora_b",),
            per_step={k1: 2 * OPT67_LAYERS, k3: OPT67_LAYERS})
    print(f"[opt-6.7b lora] peak device memory {run['peak_bytes']} bytes "
          f"({run['peak_bytes'] / 2**30:.3f} GiB) at {OPT67_LAYERS} layers")
    gc.collect()
    return run, {dkey(k3, 128): tally.dims[(k3, 128)]}


class Tee:
    """A text stream that writes to ``out`` and keeps what it wrote."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, text):
        self.text.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def layer_keeps(model, kept):
    """Hooks on the LM's decoder layers and final norm that append to
    ``kept``, in each training forward with a gradient, whether each layer
    was kept by layerdrop: a kept layer's output is the next layer's input,
    a bypassed one's input is. Returns the hooks."""
    import torch

    decoder = model.lm.decoder
    last = {}

    def active(module):
        return module.training and torch.is_grad_enabled()

    def after(module, args, output):
        if active(module):
            last["io"] = (args[0], output)

    def before(module, args):
        if active(module) and "io" in last:
            x, y = last.pop("io")
            kept.append(bool(torch.equal(args[0], y)))
            if kept[-1] == bool(torch.equal(args[0], x)):
                fail("a layer's output and input are the same tensor")

    hooks = [m.register_forward_hook(after) for m in decoder.layers]
    hooks += [m.register_forward_pre_hook(before)
              for m in (*decoder.layers[1:], decoder.final_layer_norm)]
    return hooks


def run_flags_phase(cli, fa, device, micro, test_loss, train):
    """Phase 21: the main path (config 1, OPT-125M + CLIP) with the other
    flags of this slice. The --test pass with --layerdrop 0.1 gives phase
    4's test loss (``test_loss``) bit for bit. One update with --layerdrop
    0.5 launches K1 and K3 12 times a micro-step (the layers run, then the
    select), prints the fraction of layers kept, and the layers never kept
    in it get exactly-zero gradients. One update with --fused_ce false,
    --profile_dir and --log_to_wandb true: its train step calls the plain CE
    and never the fused one, its loss and gradient norm equal phase 5's
    first update (``train``) at phase 3's bf16 tolerance, its
    trace holds device events of the port's kernels, and, wandb made
    unimportable, it prints ``[wandb] disabled: ...``."""
    import torch

    out = {}
    _, results, launches, _, _ = run_test_pass(
        cli, fa, device, OPT_LAYERDROP_TEST_ARGV, OPT_TEST_KERNELS,
        {"flash_attention_allheads": OPT_LAYERS,
         "fused_heads_attention": CLIP_LAYERS},
        {"flash_attention_allheads": OPT_LAYERS,
         "fused_heads_attention": CLIP_LAYERS}, tag="opt layerdrop")
    print(f"[opt layerdrop test] loss {results['loss']!r} against phase 4's "
          f"{test_loss!r}")
    if results["loss"] != test_loss:
        fail("the test pass with --layerdrop 0.1 is not phase 4's")
    out["layerdrop_test"] = {"test_loss": results["loss"],
                             "phase4_test_loss": test_loss,
                             "launches": launches}

    kept, hooks = [], []
    n = OPT_LAYERS

    def never_kept(name):
        return any(name.startswith(f"lm.decoder.layers.{i}.")
                   and not any(kept[m * n + i] for m in range(micro))
                   for i in range(n))

    with tempfile.TemporaryDirectory() as log_dir:
        run = run_training(
            cli, fa, device, log_dir, OPT_LAYERDROP_ARGV, OPT_TRAIN_KERNELS,
            {"flash_attention_allheads": n * micro,
             "flash_attention_allheads_bwd": n * micro,
             "fused_heads_attention": CLIP_LAYERS * micro},
            tag="opt layerdrop", updates=1,
            zero_first=(never_kept, "layerdrop bypassed the layer in every "
                                    "micro-step"),
            on_build=lambda model: hooks.extend(layer_keeps(model, kept)))
    for h in hooks:
        h.remove()
    if len(kept) != n * micro:
        fail(f"{len(kept)} layerdrop decisions read, expected {n * micro}")
    run["kept_fraction"] = sum(kept) / len(kept)
    run["kept"] = [kept[m * n:(m + 1) * n] for m in range(micro)]
    print(f"[opt layerdrop] --layerdrop 0.5: {sum(kept)} of {len(kept)} "
          f"layers kept ({run['kept_fraction']:.4f}); by micro-step "
          f"{[''.join('1' if k else '0' for k in row) for row in run['kept']]}")
    out["layerdrop_training"] = run

    # wandb made unimportable for this run: wandb.init with an API key in
    # the environment would reach for its server, and the check makes no
    # network call; the CLI must then say it is disabled
    from unittest import mock
    from mmgl_tpu_torch.train import losses

    # the CE forms called where a gradient is recorded (the train step; the
    # eval steps run under no_grad with the fused CE)
    ce_calls = collections.Counter()

    def counted(form, fn):
        def call(*a, **kw):
            if torch.is_grad_enabled():
                ce_calls[form] += 1
            return fn(*a, **kw)
        return call

    tee = Tee(sys.stdout)
    with tempfile.TemporaryDirectory() as log_dir, \
            tempfile.TemporaryDirectory() as prof_dir, \
            mock.patch.dict(sys.modules, {"wandb": None}), \
            mock.patch.object(losses, "_plain_ce",
                              counted("plain", losses._plain_ce)), \
            mock.patch.object(losses._TokenCE, "apply",
                              counted("fused", losses._TokenCE.apply)), \
            contextlib.redirect_stdout(tee):
        run = run_training(
            cli, fa, device, log_dir,
            with_flags(OPT_PLAIN_CE_ARGV, profile_dir=prof_dir),
            OPT_TRAIN_KERNELS,
            {"flash_attention_allheads": OPT_LAYERS * micro,
             "flash_attention_allheads_bwd": OPT_LAYERS * micro,
             "fused_heads_attention": CLIP_LAYERS * micro},
            tag="opt plain ce", updates=1)
        traces = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)]
        if len(traces) != 1:
            fail(f"--profile_dir wrote {traces}, expected one trace")
        size = os.path.getsize(traces[0])
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = collections.Counter(
        next(k for k in TRACE_KERNELS if k in e["name"])
        for e in kernels if any(k in e["name"] for k in TRACE_KERNELS))
    print(f"[opt plain ce] trace {os.path.basename(traces[0])}: {size} "
          f"bytes, {len(events)} events, {len(kernels)} kernel events, of "
          f"them the port's {dict(ours)}")
    if any(ours[k] == 0 for k in TRACE_KERNELS):
        fail(f"the trace names no device event of {TRACE_KERNELS}: {ours}")
    retired = sum(RETIRED_KERNEL in e["name"] for e in kernels)
    if retired:
        fail(f"the trace holds {retired} events of {RETIRED_KERNEL}, which "
             "no entry of the library launches")
    wandb = [line for line in "".join(tee.text).splitlines()
             if line.startswith("[wandb] disabled: ")]
    if not wandb:
        fail("--log_to_wandb true printed no '[wandb] disabled: ' line")
    diff = {k: abs(run[k][0] - train[k][0]) for k in ("losses", "grad_norms")}
    print(f"[opt plain ce] {wandb[0]}; the train step's CE calls "
          f"{dict(ce_calls)}; update 1 against phase 5's fused CE: "
          f"loss {run['losses'][0]:.7f} vs {train['losses'][0]:.7f}, "
          f"grad_norm {run['grad_norms'][0]:.7f} vs "
          f"{train['grad_norms'][0]:.7f}, differences {diff}")
    if not (ce_calls["plain"] > 0 and ce_calls["fused"] == 0):
        fail(f"--fused_ce false: the train step's CE calls {dict(ce_calls)}, "
             "expected the plain CE's only")
    if not all(_same(run[k][0], train[k][0]) for k in diff):
        fail("the plain CE's update is not the fused CE's")
    run.update({"phase5_update1": {"loss": train["losses"][0],
                                   "grad_norm": train["grad_norms"][0]},
                "difference": diff, "wandb": wandb[0],
                "train_step_ce_calls": dict(ce_calls),
                "trace": {"bytes": size, "events": len(events),
                          "kernel_events": len(kernels),
                          "port_kernel_events": dict(ours)}})
    out["plain_ce_profile_wandb"] = run
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mmgl_tpu_torch import cli
    from mmgl_tpu_torch.ops import _build
    from mmgl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(card)                            # name, power limit
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    start = time.perf_counter()
    laps = {}

    def lap(phase):
        """Seconds since the build started, at the end of ``phase``."""
        laps[phase] = round(time.perf_counter() - start, 1)
        print(f"[elapsed] phases up to {phase}: {laps[phase]} s")

    lib = _build.load()
    print(f"[build] {lib.path.name}: nvcc {lib.seconds:.2f} s, load "
          f"{time.perf_counter() - start:.2f} s; ptxas:")
    print("\n".join("  " + line.strip() for line in lib.ptxas.splitlines()
                    if line.strip()))

    # the worst error of each kernel (its fp16 form apart, wkey); K4 with
    # its row stats keeps its own: output, max and sum
    worst = collections.defaultdict(float)
    lap("2")
    check_opt_kernels(fa, device, worst)
    keep = check_t5_kernels(fa, device, worst)
    check_blocked_kernels(fa, device, worst)
    check_head_dim_kernels(fa, device, worst)
    check_wgmma_kernels(fa, device, worst)
    check_k4_wgmma(fa, device, worst)
    check_k7_wgmma(fa, device, worst)
    check_k8_k9_wgmma(fa, device, worst)
    check_k5_wgmma(fa, device)
    lap("3")

    test, results, opt_test, rate, peak = run_test_pass(
        cli, fa, device, OPT_TEST_ARGV, OPT_TEST_KERNELS, tag="opt")
    check_model_fp32(cli, fa, test, device, OPT_TEST_ARGV, "opt")
    del test
    with tempfile.TemporaryDirectory() as log_dir:
        train = run_training(cli, fa, device, log_dir, OPT_TRAIN_ARGV,
                             OPT_TRAIN_KERNELS, tag="opt")
    step = check_train_step(cli, fa, device, OPT_TRAIN_ARGV,
                            OPT_TRAIN_KERNELS, "opt")
    micro = TRAIN_UPDATES   # micro-batches per update (4 x 4)

    lap("5")

    # phase 5c: float16 compute on the tensor-core bodies, end to end
    # through the CLI: one OPT-125M update, one T5-base update (val and
    # test batches included), and a T5-base eval-mode micro-step (K4 and K5
    # at the cross-attention) against the CPU; OPT-350M's blocked path in
    # float16 runs in phase 9
    with tempfile.TemporaryDirectory() as log_dir:
        fp16_opt = run_training(
            cli, fa, device, log_dir, OPT_FP16_ARGV, OPT_TRAIN_KERNELS,
            {"flash_attention_allheads": OPT_LAYERS * micro,
             "flash_attention_allheads_bwd": OPT_LAYERS * micro,
             "fused_heads_attention": CLIP_LAYERS * micro},
            tag="opt fp16", updates=1,
            per_eval={"flash_attention_allheads": OPT_LAYERS,
                      "fused_heads_attention": CLIP_LAYERS})
    with ShapeTally(fa) as fp16_shapes, \
            tempfile.TemporaryDirectory() as log_dir:
        fp16_t5 = run_training(
            cli, fa, device, log_dir, T5_FP16_ARGV,
            ("flash_attention_bias", "flash_attention_bias_bwd",
             "fused_heads_attention"),
            {"flash_attention_bias": 3 * T5_LAYERS * micro,
             "flash_attention_bias_bwd": 3 * T5_LAYERS * micro},
            tag="t5 fp16", updates=1,
            per_eval={"flash_attention_bias": 2 * T5_LAYERS,
                      "flash_attention": T5_LAYERS},
            per_generate={"flash_attention_bias": T5_LAYERS})
        fp16_t5_step = check_train_step(
            cli, fa, device, T5_FP16_ARGV,
            ("flash_attention", "flash_attention_bwd"), "t5 fp16",
            tol=T5_STEP_TOL, plain_on_card=True, half=True,
            per_step={"flash_attention": T5_LAYERS,
                      "flash_attention_bwd": T5_LAYERS,
                      "flash_attention_bias": 2 * T5_LAYERS,
                      "flash_attention_bias_bwd": 2 * T5_LAYERS})

    lap("5c")
    per_eval = {"flash_attention_bias": 2 * T5_LAYERS,
                "flash_attention": T5_LAYERS,
                "fused_heads_attention": T5_LAYERS}
    per_generate = {"flash_attention_bias": T5_LAYERS, "flash_attention": 0,
                    "fused_heads_attention": T5_LAYERS}
    t5_test, t5_results, t5_test_launches, t5_rate, t5_peak = run_test_pass(
        cli, fa, device, T5_TEST_ARGV,
        ("flash_attention_bias", "flash_attention", "fused_heads_attention"),
        per_eval, per_generate, tag="t5")
    t5_model = check_model_fp32(cli, fa, t5_test, device, T5_TEST_ARGV,
                                "t5")
    del t5_test
    per_update = {"flash_attention_bias": 3 * T5_LAYERS * micro,
                  "flash_attention_bias_bwd": 3 * T5_LAYERS * micro,
                  "flash_attention": 0, "flash_attention_bwd": 0}
    # K8 and K9 are one wrapper: its launches are told apart by (Sq, Sk)
    with ShapeTally(fa) as t5_shapes, \
            tempfile.TemporaryDirectory() as log_dir:
        t5_train = run_training(
            cli, fa, device, log_dir, T5_TRAIN_ARGV,
            ("flash_attention_bias", "flash_attention_bias_bwd",
             "fused_heads_attention"), per_update, tag="t5")
    bwd_shapes = t5_shapes.bwd
    print(f"[t5 train] K8/K9 launches by (Sq, Sk): {bwd_shapes}")
    if sum(bwd_shapes.values()) != t5_train["launches"][
            "flash_attention_bias_bwd"]:
        fail("the K8/K9 launches by shape do not add up to its count")
    t5_step = check_train_step(
        cli, fa, device, T5_TRAIN_ARGV,
        ("flash_attention_bias", "flash_attention_bias_bwd",
         "flash_attention", "flash_attention_bwd"), "t5", tol=T5_STEP_TOL,
        plain_on_card=True)

    lap("7")
    rows = time_kernels(fa, device)
    lap("8")
    torch.cuda.empty_cache()    # the plain versions' (4, 16, 2048, 2048)s

    # phase 9: OPT-350M at its 2048-token window, with the blocked backward
    # selected for this phase only, through the module flag that
    # MMGL_BLOCKED_BWD=1 sets at import; in bf16, then one update in fp16.
    # K4 keeps its row stats in every launch inside the training steps and
    # in no other
    flag = fa.BLOCKED_BWD
    fa.BLOCKED_BWD = True
    per_pass = {"flash_attention": OPT350_LAYERS,
                "flash_attention_allheads": 0}
    opt350_update = {"flash_attention": OPT350_LAYERS * micro,
                     "flash_attention_blocked_bwd": OPT350_LAYERS * micro,
                     "flash_attention_allheads": 0,
                     "flash_attention_allheads_bwd": 0,
                     "flash_attention_bwd": 0}
    opt350_kernels = ("flash_attention", "flash_attention_blocked_bwd",
                      "fused_heads_attention")
    stats = {}
    try:
        with ShapeTally(fa) as tally, \
                tempfile.TemporaryDirectory() as log_dir:
            opt350 = run_training(
                cli, fa, device, log_dir, OPT350_TRAIN_ARGV, opt350_kernels,
                opt350_update, tag="opt350m", per_eval=per_pass,
                per_generate=per_pass)
        stats["bfloat16"] = tally.stats
        opt350_step = check_train_step(
            cli, fa, device, OPT350_TRAIN_ARGV,
            ("flash_attention", "flash_attention_blocked_bwd"), "opt350m",
            plain_on_card=True, on_cpu=False)
        with ShapeTally(fa) as tally, \
                tempfile.TemporaryDirectory() as log_dir:
            fp16_opt350 = run_training(
                cli, fa, device, log_dir, OPT350_FP16_ARGV, opt350_kernels,
                opt350_update, tag="opt350m fp16", per_eval=per_pass,
                per_generate=per_pass, updates=1)
        stats["float16"] = tally.stats
    finally:
        fa.BLOCKED_BWD = flag
    for dtype_name, run in (("bfloat16", opt350), ("float16", fp16_opt350)):
        if run["launches"]["flash_attention_allheads_bwd"]:
            fail(f"K3 launched in the OPT-350M {dtype_name} run")
        if stats[dtype_name] != {dtype_name: run["in_steps"][
                "flash_attention"]}:
            fail(f"K4 kept its row stats {stats[dtype_name]} times in the "
                 f"OPT-350M {dtype_name} run, expected every launch in its "
                 f"training steps ({run['in_steps']['flash_attention']})")
    print(f"[opt350m] K4 launches keeping the row stats: {stats}")

    lap("9")

    # phase 10: the embedding mode at full width, BASELINE config 2
    emb_eval = {"flash_attention_allheads": ROBERTA_LAYERS,
                "fused_heads_attention": CLIP_LAYERS,
                "flash_attention_bias": 2 * T5_LAYERS,
                "flash_attention": T5_LAYERS}
    emb_gen = {"flash_attention_allheads": ROBERTA_LAYERS,
               "fused_heads_attention": CLIP_LAYERS,
               "flash_attention_bias": T5_LAYERS, "flash_attention": 0}
    emb_kernels = ("flash_attention_allheads", "fused_heads_attention",
                   "flash_attention_bias", "flash_attention")
    emb_test, emb_results, emb_test_launches, emb_rate, emb_peak = \
        run_test_pass(cli, fa, device, T5_EMB_TEST_ARGV, emb_kernels,
                      emb_eval, emb_gen, tag="t5 emb")
    emb_model = check_model_fp32(cli, fa, emb_test, device,
                                 T5_EMB_TEST_ARGV, "t5 emb")
    del emb_test
    emb_update = {"flash_attention_allheads": ROBERTA_LAYERS * micro,
                  "fused_heads_attention": CLIP_LAYERS * micro,
                  "flash_attention_bias": 3 * T5_LAYERS * micro,
                  "flash_attention_bias_bwd": 3 * T5_LAYERS * micro,
                  "flash_attention_allheads_bwd": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0}
    with ShapeTally(fa) as emb_shapes, \
            tempfile.TemporaryDirectory() as log_dir:
        emb_train = run_training(
            cli, fa, device, log_dir, T5_EMB_TRAIN_ARGV,
            ("flash_attention_allheads", "fused_heads_attention",
             "flash_attention_bias", "flash_attention_bias_bwd"),
            emb_update, tag="t5 emb", per_eval=emb_eval,
            per_generate=emb_gen)
    print(f"[t5 emb train] K7 launches by (Sq, Sk): {emb_shapes.fwd}; "
          f"K8/K9: {emb_shapes.bwd}")
    if not emb_shapes.bwd.get((576, 576)) or not emb_shapes.fwd.get(
            (576, 576)):
        fail("K7 and K9 did not run at the 576-token encoder")
    # in eval mode (no dropout) the cross-attention takes K4 and K5 at
    # 128 x 576; the encoder K7 and K9 at 576 x 576
    emb_step = check_train_step(
        cli, fa, device, T5_EMB_TRAIN_ARGV,
        ("flash_attention", "flash_attention_bwd", "flash_attention_bias",
         "flash_attention_bias_bwd"), "t5 emb", tol=T5_STEP_TOL,
        plain_on_card=True, half=True,
        per_step={"flash_attention": T5_LAYERS,
                  "flash_attention_bwd": T5_LAYERS,
                  "flash_attention_bias": 2 * T5_LAYERS,
                  "flash_attention_bias_bwd": 2 * T5_LAYERS,
                  "flash_attention_allheads": ROBERTA_LAYERS,
                  "fused_heads_attention": CLIP_LAYERS,
                  "flash_attention_allheads_bwd": 0})

    lap("10")

    # phase 11: OPT-125M + Roberta + CLIP, context all, embedding, with the
    # Laplacian and the GCN position encodings: one update through the CLI
    # each, OPT at 640 + 64 = 704 tokens (K1/K3), its prefill at 576
    graph = {}
    per = {"flash_attention_allheads": ROBERTA_LAYERS + OPT_LAYERS,
           "fused_heads_attention": CLIP_LAYERS}
    for pt, argv in OPT_GRAPH_ARGV.items():
        with tempfile.TemporaryDirectory() as log_dir:
            graph[pt] = run_training(
                cli, fa, device, log_dir, argv,
                ("flash_attention_allheads", "flash_attention_allheads_bwd",
                 "fused_heads_attention"),
                {"flash_attention_allheads":
                     (ROBERTA_LAYERS + OPT_LAYERS) * micro,
                 "flash_attention_allheads_bwd": OPT_LAYERS * micro,
                 "flash_attention": 0,
                 "fused_heads_attention": CLIP_LAYERS * micro},
                tag=f"opt {pt}", per_eval=per, per_generate=per, updates=1,
                idle=OPT_GRAPH_IDLE)

    lap("11")
    peft = run_peft_phases(cli, fa, device, micro, lap)
    cached = run_cached_phases(cli, fa, device, micro, train, emb_train)
    lap("15")
    opt67_summary, launches_d128 = run_opt67_phase(cli, fa, device)
    lap("16")

    # phases 17 and 18 run in a directory holding the checkpoints they
    # write, which the flags name relative to it
    with tempfile.TemporaryDirectory() as ckpt_root, \
            contextlib.chdir(ckpt_root):
        files = write_checkpoints(ckpt_root)
        ckpt_summary = run_checkpoint_phase(cli, fa, device, files,
                                            results["loss"])
        lap("17")
        family7, launches_family7 = run_family7_phase(cli, fa, device,
                                                      micro, files)
        del files
    lap("18")
    remat = run_remat_phase(cli, fa, device, micro,
                            peft["runs"]["opt13b_lora_training"])
    lap("19")
    opt67_train, launches_d128_train = run_opt67_train_phase(cli, fa, device,
                                                             micro)
    lap("20")
    flags = run_flags_phase(cli, fa, device, micro, results["loss"], train)
    lap("21")

    print(json.dumps({"opt_test": {
        "sections_per_s": rate, "peak_bytes": peak,
        "test_loss": results["loss"], "launches": opt_test, "card": card}}))
    print(json.dumps({"opt_training": {**train, "fp32_step": step,
                                       "card": card}}))
    print(json.dumps({"t5_test": {
        "sections_per_s": t5_rate, "peak_bytes": t5_peak,
        "test_loss": t5_results["loss"], "launches": t5_test_launches,
        "fp32_eval": t5_model, "card": card}}))
    print(json.dumps({"t5_training": {**t5_train, "fp32_step": t5_step,
                                      "dropout_keep_fraction": keep,
                                      "card": card}}))
    print(json.dumps({"opt350m_training": {**opt350, "fp32_step": opt350_step,
                                           "k4_stats_launches": stats,
                                           "card": card}}))
    print(json.dumps({"fp16": {"opt": fp16_opt, "t5": fp16_t5,
                               "t5_eval_mode_step": fp16_t5_step,
                               "opt350m": fp16_opt350, "card": card}}))
    print(json.dumps({"t5_embedding_test": {
        "sections_per_s": emb_rate, "peak_bytes": emb_peak,
        "test_loss": emb_results["loss"], "launches": emb_test_launches,
        "fp32_eval": emb_model, "card": card}}))
    print(json.dumps({"t5_embedding_training": {
        **emb_train, "eval_mode_step": emb_step,
        "k7_by_shape": {f"{a}x{b}": n for (a, b), n in emb_shapes.fwd.items()},
        "k8_k9_by_shape": {f"{a}x{b}": n
                           for (a, b), n in emb_shapes.bwd.items()},
        "card": card}}))
    print(json.dumps({"opt_graph": {**graph, "card": card}}))
    for key, run in peft["runs"].items():
        print(json.dumps({key: {**run, "card": card}}))
    for key, run in cached.items():
        print(json.dumps({key: {**run, "card": card}}))
    print(json.dumps({"opt67b_test": {**opt67_summary, "card": card}}))
    print(json.dumps({"opt_checkpoint_test": {**ckpt_summary,
                                              "card": card}}))
    print(json.dumps({"mpt27b_cliptext_training": {**family7,
                                                   "card": card}}))
    print(json.dumps({"opt13b_lora_remat_training": {**remat, "card": card}}))
    print(json.dumps({"opt67b_lora_training": {**opt67_train,
                                               "card": card}}))
    for key, run in flags.items():
        print(json.dumps({f"opt_{key}": {**run, "card": card}}))

    # each kernel's launches from the path that runs it: K1-K3 the OPT
    # training run, K4 the T5 test pass, K7/K8/K9 the T5 training run, K5
    # the T5 fp32 micro-step (its gradient runs only where dropout is off)
    launches = dict(train["launches"])
    launches["flash_attention"] = t5_test_launches["flash_attention"]
    launches["flash_attention_bias"] = t5_train["launches"][
        "flash_attention_bias"]
    launches["flash_attention_bwd"] = t5_step["launches"][
        "flash_attention_bwd"]
    # K9 at the encoder's 512 x 512, K8 at the decoder's shapes
    # K9 at the encoder, K8 at the decoder's self- and cross-attention
    k9 = bwd_shapes.get((512, 512), 0)
    cross = bwd_shapes.get((128, 512), 0)
    launches["flash_attention_bias_bwd[K9]"] = k9
    launches["flash_attention_bias_bwd[K8,cross]"] = cross
    launches["flash_attention_bias_bwd[K8]"] = (sum(bwd_shapes.values())
                                                - k9 - cross)
    # K4 with its stats and K6: the OPT-350M training run (its eval steps
    # and prefills run K4 without the stats)
    launches["flash_attention[stats]"] = stats["bfloat16"]["bfloat16"]
    launches["flash_attention_blocked_bwd"] = opt350["launches"][
        "flash_attention_blocked_bwd"]
    # the embedding slice: K1 at Roberta's shape (all of its K1 launches),
    # K7 and K9 at the 576-token encoder, from its training run
    launches["flash_attention_allheads[roberta]"] = emb_train["launches"][
        "flash_attention_allheads"]
    launches["flash_attention_bias[576]"] = emb_shapes.fwd[(576, 576)]
    launches["flash_attention_bias_bwd[K9,576]"] = emb_shapes.bwd[(576, 576)]
    # the fp16 forms: the fp16 runs of phases 5c and 9
    fp16_runs = (fp16_opt, fp16_t5, fp16_t5_step, fp16_opt350)
    for name in KERNELS:
        launches[wkey(name, "float16")] = sum(
            run["launches"][name] for run in fp16_runs)
    fp16_k9 = fp16_shapes.bwd.get((512, 512), 0)
    fp16_cross = fp16_shapes.bwd.get((128, 512), 0)
    launches[wkey("flash_attention_bias_bwd[K9]", "float16")] = fp16_k9
    launches[wkey("flash_attention_bias_bwd[K8,cross]", "float16")] = \
        fp16_cross
    launches[wkey("flash_attention_bias_bwd[K8]", "float16")] = sum(
        fp16_shapes.bwd.values()) - fp16_k9 - fp16_cross
    launches[wkey("flash_attention[stats]", "float16")] = stats[
        "float16"]["float16"]
    # phases 12-14: the new shapes of K4/K5 (MPT's cross-attention, prefix
    # tuning) and K7/K8 (T5's prefixed decoder), each from the run that
    # takes it, prefills and eval steps included
    launches.update(peft["launches"])
    # head dims 80 (phase 18, MPT-2.7B at 8 layers) and 128 (phase
    # 16, OPT-6.7B), and K2 causal at the CLIP text tower's shape (phase 18)
    launches.update(launches_d128)
    launches.update(launches_family7)
    # K3 at head dim 128: OPT-6.7B + LoRA's training (phase 20)
    launches.update(launches_d128_train)
    entries = []
    timed_label = {}
    for label, (name, _, _, _) in rows.items():
        # a kernel's line takes its first timed case (K7: the encoder in
        # eval); every case is printed above. K5 at OPT-350M's shape is
        # timed beside K6 only: no main path runs it there
        if name in launches:
            timed_label.setdefault(name, label)
    for name, label in timed_label.items():
        base = name.split("[")[0]
        fp16 = name.endswith("[fp16]")
        _, replaces, source = KERNELS[base]
        if "[K9" in name:
            replaces = f"{PALLAS}:984"
        _, times, bound, by = rows[label]
        # the worst error over the kernel's phase-3 checks in its dtype (bf16
        # and fp32 together, fp16 apart; K4 with its stats apart)
        err = (name if name in worst else
               wkey("flash_attention[stats]" if "[stats]" in name else base,
                    "float16" if fp16 else "bfloat16"))
        design = ("wgmma_tma_bias" if base == "flash_attention_bias" else
                  "bias_tc" if base == "flash_attention_bias_bwd" else
                  "wgmma_tma")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[err],
            "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": times["library"], "shape": label,
            "dtype": "float16" if fp16 else "bfloat16",
            "design": design, "design_text": DESIGNS[design]})
    print(json.dumps({"elapsed_s": laps, "card": card}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
