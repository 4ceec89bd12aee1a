"""Serving: batching engine over compiled circuit programs."""
