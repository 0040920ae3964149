"""How the port takes CLIP's vision tower: the checkpoint's tensors
through its importer (``utils/hf_import.import_clip_vision``) into
``visual_model``, the fusion block's projection into ``visual_embeddings``
(the module whose input is the tower's pooled output)."""

from benchmark import program

POOLED_INTO = "visual_embeddings"


def load(model, part, hf, extra) -> int:
    from mmgl_tpu_torch.utils import hf_import

    return (program.overlay(model, "visual_model",
                            hf_import.import_clip_vision(hf))
            + program.overlay_linears(model, extra))
