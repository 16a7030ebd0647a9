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
                                      blocks_for_tokens, copy_block,
                                      gather_prefix_blocks,
                                      write_chunk_blocks)
from repro_torch.serve.request import Request, RequestState, RequestStatus
from repro_torch.serve.sampling import (nucleus_mask, sample_np,
                                        sample_tokens, truncated_probs_np)
from repro_torch.serve.speculative import (DraftProposer, NGramProposer,
                                           greedy_verify, make_proposer,
                                           rejection_verify)

__all__ = ["AdmissionQueue", "BlockAllocator", "DraftProposer",
           "ENGINE_ROLES", "EngineConfig", "NGramProposer", "NULL_BLOCK",
           "Request", "RequestRecord", "RequestState", "RequestStatus",
           "ServeEngine", "ServeMetrics", "VirtualClock", "WallClock",
           "blocks_for_tokens", "bursty_requests", "copy_block",
           "engine_config_for", "gather_prefix_blocks", "greedy_verify",
           "load_trace", "long_context_requests", "make_proposer",
           "merge_requests", "nucleus_mask", "percentiles",
           "poisson_requests", "rejection_verify", "sample_np",
           "sample_tokens", "split_seeds", "trace_requests",
           "truncated_probs_np", "write_chunk_blocks"]
