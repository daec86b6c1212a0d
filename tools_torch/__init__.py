"""The repository's tools run on the PyTorch port (``cassandra_accord_tpu_torch``):
``perfgate`` and ``explain``, each the twin of its ``tools/`` file with its
imports pointed at the port.  Importable as ``tools_torch.*`` from the
repository root, runnable as scripts."""
