"""The dense encoder family: config, layers, attention, blocks, model."""
