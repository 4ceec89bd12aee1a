"""Datasets of the port: the five seeded tabular stand-ins."""
