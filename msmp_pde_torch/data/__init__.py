"""Static graphs and window ops."""
