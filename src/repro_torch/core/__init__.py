# The paper's primary contribution: versioned KGE production (the
# updater) and serving (snapshots published to a registry, batched top-k).
from .provenance import prov_record, validate_prov
from .registry import EmbeddingRegistry
from .serving import (BatchScheduler, ClosestConcept, EmbeddingIndex,
                      LRUIndexCache, SchedulerError, ServingEngine,
                      SimRequest, Ticket, TopKRequest)
from .updater import (PAPER_MODELS, FileReleaseChannel, ReleaseChannel,
                      SyntheticReleaseChannel, UpdatePlan, UpdateReport,
                      Updater, poll_loop)

__all__ = [
    "prov_record", "validate_prov", "EmbeddingRegistry",
    "BatchScheduler", "ClosestConcept", "EmbeddingIndex", "LRUIndexCache",
    "SchedulerError", "ServingEngine", "SimRequest", "Ticket", "TopKRequest",
    "PAPER_MODELS", "FileReleaseChannel", "ReleaseChannel",
    "SyntheticReleaseChannel", "UpdatePlan", "UpdateReport", "Updater",
    "poll_loop",
]
