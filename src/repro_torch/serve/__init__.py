"""Continuous-batching serving on a slab or paged KV pool (port of
``repro.serve``)."""
from repro_torch.serve.arrivals import (AdmissionQueue, VirtualClock,
                                        WallClock, bursty_requests,
                                        load_trace, long_context_requests,
                                        merge_requests, poisson_requests,
                                        split_seeds, trace_requests)
from repro_torch.serve.engine import (ENGINE_ROLES, EngineConfig, ServeEngine,
                                      engine_config_for)
from repro_torch.serve.metrics import RequestRecord, ServeMetrics, percentiles
from repro_torch.serve.paging import (NULL_BLOCK, BlockAllocator,
                                      blocks_for_tokens, write_chunk_blocks)
from repro_torch.serve.request import Request, RequestState, RequestStatus
from repro_torch.serve.sampling import (nucleus_mask, sample_np,
                                        sample_tokens, truncated_probs_np)

__all__ = ["AdmissionQueue", "BlockAllocator", "ENGINE_ROLES", "EngineConfig",
           "NULL_BLOCK", "Request", "RequestRecord", "RequestState",
           "RequestStatus", "ServeEngine", "ServeMetrics", "VirtualClock",
           "WallClock", "blocks_for_tokens", "bursty_requests",
           "engine_config_for", "load_trace", "long_context_requests",
           "merge_requests", "nucleus_mask", "percentiles",
           "poisson_requests", "sample_np", "sample_tokens", "split_seeds",
           "trace_requests", "truncated_probs_np", "write_chunk_blocks"]
