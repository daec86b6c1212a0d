"""Persistent batched device consult service (the protocol-path device tier).

``DeviceConsultService`` (service.py) owns a persistent, incrementally
refreshed device-resident conflict index (index.py), a ragged batching
window with pow2 bucket shapes (batch.py), and a futures-based
submission API the resolver routes protocol consults through.  See each
module's docstring; README "Device consult service" for the operator view.
"""
from .batch import ConsultBatch, build_batch, pow2_bucket, split_rows
from .index import DoubleBufferedIndex, front_from_host
from .service import AsyncResult, DeviceConsultService

__all__ = ["AsyncResult", "ConsultBatch", "DeviceConsultService",
           "DoubleBufferedIndex", "build_batch", "front_from_host",
           "pow2_bucket", "split_rows"]
