"""Training and evaluation loops (eval side only so far)."""
