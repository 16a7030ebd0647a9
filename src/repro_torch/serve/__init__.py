"""Continuous-batching serving on a slab or paged KV pool (port of
``repro.serve``)."""
from repro_torch.serve.arrivals import AdmissionQueue, VirtualClock, WallClock
from repro_torch.serve.engine import EngineConfig, ServeEngine, engine_config_for
from repro_torch.serve.paging import (NULL_BLOCK, BlockAllocator,
                                      blocks_for_tokens, write_chunk_blocks)
from repro_torch.serve.request import Request, RequestState, RequestStatus

__all__ = ["AdmissionQueue", "BlockAllocator", "EngineConfig", "NULL_BLOCK",
           "Request", "RequestState", "RequestStatus", "ServeEngine",
           "VirtualClock", "WallClock", "blocks_for_tokens",
           "engine_config_for", "write_chunk_blocks"]
