"""Serving demos of the port: the stdlib HTTP server (demos/server.py)."""
