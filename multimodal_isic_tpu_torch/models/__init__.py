"""Models: EfficientNet backbone, multimodal fusion net, weight conversion
from the JAX package's parameters."""
