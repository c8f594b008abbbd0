"""Serving of the port: the continuous-batching decode engine."""
