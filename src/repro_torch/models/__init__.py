"""Model definitions: config, shared layers, GQA and MLA attention, the
dense and MoE transformer (``moe``: routing, capacity dispatch, grouped
expert GEMMs, shared experts), the encoder-decoder (``encdec``), the
recurrent families (``xlstm``, ``griffin``), and the architecture
registry."""
