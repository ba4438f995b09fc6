"""Developer tools for the port (profiling on the card)."""
