"""Architecture configs. Importing this package registers every ported
arch with the model registry (``repro_torch.models.registry.get_arch``);
``shapes`` holds the input-shape grid and each cell's input specs."""
from . import (deepseek_v2, granite_34b, llama32_3b,  # noqa: F401
               llama32_vision_90b, minicpm3_4b, mixtral_8x7b, paper_llama,
               phi35_moe, qwen2_72b, recurrentgemma_9b, whisper_tiny,
               xlstm_1b3)
from .shapes import (SHAPES, Shape, input_specs, memory_arg,  # noqa: F401
                     shape_applicable)
