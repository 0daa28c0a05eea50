"""Files: checkpoints (safetensors, GGUF), audio (WAV, other containers
through ``media``), ``.mimi`` token files, and the realtime frame driver
with its live audio device backends."""
