"""cassandra_accord_tpu_torch — the Accord consensus framework with its device
plane in PyTorch and hand-written CUDA kernels for one NVIDIA H100.

This is the port of ``cassandra_accord_tpu`` (the JAX/TPU package beside it,
which stays the reference).  The host control plane is carried over with the
same code; the device plane is rewritten:

- ``utils`` ``primitives`` ``api`` ``topology`` ``local`` ``messages``
  ``coordinate`` ``impl`` ``protocol_batch`` ``native`` ``harness``
  ``maelstrom`` ``observe`` — carried over (host Python, no device code),
  except the modules below;
- ``config``          the reference's LocalConfig plus ``device`` ("cuda" by
                      default; "cpu" only when asked for);
- ``device``          resolves that field, raising when the card is missing;
- ``ops``             lane contract, the consult (``deps_kernels``,
                      ``pallas_join``) and the release frontier in torch;
                      ``ops/_kernels`` builds and launches the CUDA kernels
                      of ``csrc/consult.cu`` (K1 deps join, K2 max conflict);
- ``device_service``  the persistent batched consult service over a
                      copy-on-write device index;
- ``impl.tpu_resolver`` the device-tier resolver on torch tensors;
- ``observe.device``/``observe.profiler`` share-of-peak against the H100.

Not ported yet: ``models`` (the batched conflict-graph engine), ``parallel``
(multi-device), and the closure/SCC/levels kernels of ``ops``.
"""

__version__ = "0.1.0"
