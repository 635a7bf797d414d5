"""Architecture configs. Importing this package registers every ported
arch with the model registry (``repro_torch.models.registry.get_arch``)."""
from . import llama32_3b, mixtral_8x7b, paper_llama  # noqa: F401
