"""AutoComp: automated data compaction for log-structured tables (the
paper's contribution), structured as the OODA workflow of Fig. 4:

  candidates -> [observe: stats] -> (filter) -> [orient: traits] -> (filter)
             -> [decide: rank + select] -> [act: schedule + execute]
             -> feedback loop back to observe

Every phase is a pluggable component (NFR1) and every default implementation
is deterministic under identical inputs (NFR2). Nothing here knows about
Iceberg vs. our LST substrate beyond the connector protocol (NFR3).

Ported so far: the single-pool OODA loop and the retention queue. The fleet
scheduler, the service, the triggers and the autotuner are still to port.
"""

from repro_torch.core.model import Candidate, CandidateStats, Scope  # noqa: F401
from repro_torch.core.observe import StatsCollector  # noqa: F401
from repro_torch.core.orient import (  # noqa: F401
    ComputeCostTrait, FileCountReductionTrait, FileEntropyTrait, TraitContext,
)
from repro_torch.core.decide import (  # noqa: F401
    BudgetSelection, MoopRanker, ThresholdPolicy, TopKSelection,
    quota_adaptive_weights, select_budget, select_topk,
)
from repro_torch.core.ooda import AutoCompPipeline, CycleReport  # noqa: F401
from repro_torch.core.retention import RetentionQueue  # noqa: F401
