"""Datasets of the port: the five seeded tabular stand-ins and the
synthetic LM token stream."""
