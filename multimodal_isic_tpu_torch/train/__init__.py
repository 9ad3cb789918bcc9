"""Training and evaluation loops: the fusion classifier, ConvMAE's forward
steps (latent extraction, masked validation)."""
