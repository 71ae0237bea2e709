"""Dataset generation: initial conditions, the writer and the CLI."""
