"""How the port takes OPT's weights: the checkpoint's tensors through its
importer (``utils/hf_import.import_opt``), LoRA's under the LM's layer
paths, into the model's ``lm`` through the factory's overlay."""

from benchmark import program


def load(model, part, hf, extra) -> int:
    from mmgl_tpu_torch.utils import hf_import

    tree = hf_import.import_opt(hf)
    for name, value in extra.items():
        # model.decoder.layers.<i>.self_attn.<proj>.lora_<a|b>
        parts = name.split(".")
        i = parts.index("layers")
        program.set_path(tree, parts[1:i] + [f"layers_{parts[i + 1]}"]
                         + parts[i + 2:], value)
    return program.overlay(model, "lm", tree)
