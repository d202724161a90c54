"""Aggregation rules, attacks, and the local robust-aggregation engine."""
