"""Model definitions: config, shared layers, GQA and MLA attention, the
dense and MoE transformer (``moe``: routing, capacity dispatch, grouped
expert GEMMs, shared experts), and the architecture registry."""
