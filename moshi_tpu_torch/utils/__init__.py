"""Debug tools: value capture, replay of recorded ops, frame timing."""
