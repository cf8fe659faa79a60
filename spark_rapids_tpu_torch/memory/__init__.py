"""Device memory management of the port (reference: spark_rapids_tpu/memory:
the device budget, the admission semaphore and the spill framework)."""
