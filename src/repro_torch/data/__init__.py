"""Datasets and query workloads for the port (seeded, generated here)."""
