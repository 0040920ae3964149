"""Tiny cells for the CPU tests: the benchmark's files copied into a
temporary root with two small configurations (OPT in its post-LN,
projected form with dropout and a CLIP tower, raw ``all`` context; and
pre-LN OPT with LoRA and a Roberta tower in the embedding mode), their
traffic mixes and check files, and a BENCHMARK.json naming them. The
port's factory only knows its tabled sizes, so the post-LN form takes
OPT-350M's row shrunk to tiny widths (``shrink_350m``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

VISION = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=64, image_size=32, patch_size=8,
              hidden_act="quick_gelu")
TEXT = dict(vocab_size=260, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=514, type_vocab_size=1, hidden_act="gelu")
TRAIN = dict(task="section", bf16=False, compute_dtype="float32",
             param_dtype="float32", tokenizer_path="byte:260",
             learning_rate=0.01, adam_beta1=0.9, adam_beta2=0.95,
             weight_decay=0.01, grad_clip=1.0, lr_warmup_steps=2,
             lr_schedule_step_size=5, lr_schedule_gamma=0.1,
             steps_per_epoch=100, print_freq=2,
             cache_neighbor_embeddings=False, dataloader_num_workers=1,
             prefetch_batches=2, n_visual_tokens=2, n_text_tokens=2)
CORPUS = dict(pages=12, sections=[4, 7], title_words=[2, 4],
              description_words=[4, 8], summary_words=[3, 8],
              rest_words=[4, 12], caption_words=[2, 4], image_prob=0.5,
              image_size=32)
LIMITS = dict(batch_diff=0, tower_gap=1e-4, loss_gap=1e-4, grad_gap=1e-3,
              change_gap=1e-3, optim_diff=0)

CONFIGS = {
    "tiny-post": dict(
        source="https://huggingface.co/facebook/opt-350m",
        model=dict(vocab_size=260, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=2, ffn_dim=128, word_embed_proj_dim=32,
                   max_position_embeddings=2048, do_layer_norm_before=False,
                   activation_function="relu", dropout=0.1),
        vision=VISION, reduced=[],
        settings=dict(TRAIN, model_name_or_path="opt-350m-tiny",
                      context="all", neighbor_mode="raw", peft_type="none",
                      freeze_lm=False),
        optimizer="adamw", assembler="decoder_only",
        parts=[dict(part="model", family="opt", trains=True),
               dict(part="vision", family="clip_vision")]),
    "tiny-lora": dict(
        source="https://huggingface.co/facebook/opt-1.3b",
        model=dict(vocab_size=260, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=2, ffn_dim=128, word_embed_proj_dim=64,
                   max_position_embeddings=2048, do_layer_norm_before=True,
                   activation_function="relu", dropout=0.0),
        text=TEXT, reduced=[],
        settings=dict(TRAIN, model_name_or_path="opt-tiny",
                      context="text_only", neighbor_mode="embedding",
                      text_model="roberta-base", position_type="none",
                      peft_type="lora", lora_r=4, lora_alpha=1.0,
                      lora_dropout=0.0, freeze_lm=True),
        optimizer="adamw", assembler="decoder_only",
        parts=[dict(part="model", family="opt", trains=False),
               dict(part="text", family="roberta")]),
}
TRAFFIC = {
    "tiny.raw": dict(settings=dict(
        max_input_length=96, max_output_length=32,
        per_device_train_batch_size=2, grad_accumulation_steps=2,
        max_text_neighbors=3, max_image_neighbors=2), corpus=CORPUS),
    "tiny.emb": dict(settings=dict(
        max_input_length=32, max_output_length=16,
        per_device_train_batch_size=2, grad_accumulation_steps=2,
        max_text_neighbors=3, max_image_neighbors=2), corpus=CORPUS),
}
CELLS = {"tiny-post.raw": ("tiny-post", "tiny.raw"),
         "tiny-lora.emb": ("tiny-lora", "tiny.emb")}


def make_root(tmp: Path) -> Path:
    """A checkout-like root holding the benchmark and the tiny cells."""
    root = tmp / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in CONFIGS.items():
        path = f"benchmark/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        bench["configs"].append(dict(name=name, source=cfg["source"],
                                     file=path, reduced=[], why="a test"))
    for name, traffic in TRAFFIC.items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
    for name, (config, traffic) in CELLS.items():
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(
            json.dumps(dict(trace_updates=2, limits=LIMITS)))
        bench["workloads"].append(dict(name=name, config=config,
                                       traffic=traffic, chips=1,
                                       why="a test"))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        metric.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def shrink_350m(monkeypatch):
    """The factory's OPT-350M row at tiny widths, looked up first, so that
    ``opt-350m-tiny`` builds a tiny post-LN OPT with project_in/out and
    the tiny CLIP tower."""
    from mmgl_tpu_torch.models import factory

    sizes = {"350m": (64, 2, 2, 128, 32)}
    sizes.update({k: v for k, v in factory._OPT_SIZES.items()
                  if k != "350m"})
    monkeypatch.setattr(factory, "_OPT_SIZES", sizes)


@pytest.fixture
def one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
