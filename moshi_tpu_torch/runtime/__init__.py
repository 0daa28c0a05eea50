"""Runtime helpers: synthetic weights and parameter-tree conversion."""
