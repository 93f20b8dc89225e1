"""Model configurations (the dense transformers served so far)."""
