"""Checkpoint files: safetensors and GGUF."""
