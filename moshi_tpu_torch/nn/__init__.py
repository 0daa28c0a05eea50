"""Layers, attention, KV rings and the transformer stack."""
