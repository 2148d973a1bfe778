"""Model family of the port: the dense LLaMA-style transformer."""
