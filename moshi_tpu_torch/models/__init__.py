"""Models: the Moshi LM frame step."""
