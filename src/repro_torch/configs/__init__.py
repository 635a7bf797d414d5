"""Architecture configs. Importing this package registers every ported
arch with the model registry (``repro_torch.models.registry.get_arch``)."""
from . import (granite_34b, llama32_3b, mixtral_8x7b,  # noqa: F401
               paper_llama, phi35_moe, qwen2_72b)
