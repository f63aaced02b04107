"""Fault-tolerant training driver and simulated failures."""
