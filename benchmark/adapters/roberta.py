"""How the port takes Roberta: the checkpoint's tensors through its
importer (``utils/hf_import.import_roberta``) into ``text_model``, the
fusion block's pooler and projection into ``text_pooler`` and
``text_embeddings`` (the module whose input is the pooler's output)."""

from benchmark import program

POOLED_INTO = "text_embeddings"


def load(model, part, hf, extra) -> int:
    from mmgl_tpu_torch.utils import hf_import

    return (program.overlay(model, "text_model",
                            hf_import.import_roberta(hf))
            + program.overlay_linears(model, extra))
