"""Step functions and the serving CLI."""
