"""Summarization quality metrics: BLEU, ROUGE, CIDEr.

Pure python/numpy implementations with the same corpus-level semantics as the
metrics the reference driver uses (torchmetrics BLEUScore / ROUGEScore and the
vendored CIDEr scorer — run_generation.py:32-33,544-546,653-671).
"""

from mmgl_tpu_torch.metrics.bleu import bleu_score  # noqa: F401
from mmgl_tpu_torch.metrics.rouge import rouge_score  # noqa: F401
from mmgl_tpu_torch.metrics.cider import Cider, cider_score  # noqa: F401
