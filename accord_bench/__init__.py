"""The benchmark of cassandra_accord_tpu_torch (see README.md)."""
