from mmgl_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, apply_fsdp, apply_zero1, gather_tokens, init_distributed,
    leaf_spec, make_mesh, param_specs)
