"""Models: EfficientNet backbone, multimodal fusion net, ConvMAE, weight
conversion from the JAX package's parameters."""
