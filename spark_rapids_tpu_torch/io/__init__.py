"""Parquet read and write for the port (port of spark_rapids_tpu/io/):
the footer reader, the device decode and encode, the scan execs, the
DataFrame reader and the writer. No Arrow on any path."""
