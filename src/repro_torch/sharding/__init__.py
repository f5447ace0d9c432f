"""Placement specs of the port (``repro.sharding``): the federated half."""
