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
- ``ops``             graph state, the consult (``deps_kernels``,
                      ``pallas_join``), the closure/SCC/Kahn graph ops and
                      the edge-frontier tier in torch; ``ops/_kernels``
                      builds and launches the CUDA kernels of
                      ``csrc/consult.cu`` (K1 deps join, K2 max conflict:
                      the CSR form) and ``csrc/dense_join.cu`` (K1d, K2d:
                      the dense tensor-core form, for wide rows);
- ``models``          the conflict-graph model (``txn_step``: witness,
                      stabilise, one execution wave; its join is K1);
- ``parallel``        the multi-device data plane over torch.distributed,
                      one process per rank (``launch.run_ranks``): the
                      sharded step, the store-sharded consult, the per-store
                      frontier and the row-parallel closure (``mesh``), and
                      the live-state dry run (``live_dryrun``, carried over);
- ``entry``           ``entry(device)``: that step with example arguments;
                      ``dryrun_multichip(n, device, backend)``: the sharded
                      plane over n ranks;
- ``device_service``  the persistent batched consult service over a
                      copy-on-write device index;
- ``impl.tpu_resolver`` the device-tier resolver on torch tensors;
- ``observe.device``/``observe.profiler`` share-of-peak against the H100.

Not ported yet: the port's own tools and bench (``tools/`` and
``bench.py`` sit outside the reference package).
"""

__version__ = "0.1.0"
