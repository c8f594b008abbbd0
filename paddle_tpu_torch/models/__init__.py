"""Models of the port (so far the generation transformer LM)."""
