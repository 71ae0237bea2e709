"""Bucketed rollout engine and HTTP server."""
