"""Model definitions: config, shared layers, GQA attention, the dense and
MoE transformer (``moe``: routing, capacity dispatch, grouped expert
GEMMs), and the architecture registry."""
