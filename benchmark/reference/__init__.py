"""Plain PyTorch references, one per model family."""
