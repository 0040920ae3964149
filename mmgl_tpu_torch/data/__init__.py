from mmgl_tpu_torch.data.store import PageStore, load_wikiweb2m  # noqa: F401
from mmgl_tpu_torch.data.assemble import WikiWeb2MAssembler  # noqa: F401
from mmgl_tpu_torch.data.loader import PrefetchLoader  # noqa: F401
