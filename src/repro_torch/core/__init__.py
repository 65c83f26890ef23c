# The paper's primary contribution, serving side: versioned snapshots
# published to a registry and served through batched top-k.
from .provenance import prov_record, validate_prov
from .registry import EmbeddingRegistry
from .serving import (BatchScheduler, ClosestConcept, EmbeddingIndex,
                      LRUIndexCache, SchedulerError, ServingEngine,
                      SimRequest, Ticket, TopKRequest)

__all__ = [
    "prov_record", "validate_prov", "EmbeddingRegistry",
    "BatchScheduler", "ClosestConcept", "EmbeddingIndex", "LRUIndexCache",
    "SchedulerError", "ServingEngine", "SimRequest", "Ticket", "TopKRequest",
]
