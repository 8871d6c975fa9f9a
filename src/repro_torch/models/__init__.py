"""Model code of the port: config, layers, attention, blocks, LM."""
