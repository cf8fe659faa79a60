"""Execution-time fault tolerance of the port (reference:
spark_rapids_tpu/engine: retry combinators and the cancellation helpers
they call)."""
