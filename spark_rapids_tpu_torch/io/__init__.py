"""Parquet, ORC and CSV read and write for the port (port of
spark_rapids_tpu/io/): the footer readers, the device decodes and
encodes, the CSV field plans, parse kernels and host grammar, the scan
execs, the DataFrame reader and the writer. No Arrow on any path."""
