"""Model definitions: config, shared layers, GQA attention, the dense
transformer, and the architecture registry."""
