"""Utilities of the port: query metrics and the fault-injection harness."""
