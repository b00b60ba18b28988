"""Scenario-campaign engine: grids of FL runs with statistics, each
synchronous group of (cell, seed) runs batched through one launch of each
kernel a step.

Counterpart of ``repro/sim``. Declare a grid with :class:`CampaignSpec`
(base FLConfig + cell overrides + seeds), execute it with
:func:`run_campaign` (which lowers the spec through :func:`plan_campaign`
into a :class:`CampaignPlan` — fused heterogeneous-M groups, cached
preparation, overlapped dispatch), and read per-cell trajectories with
mean ± CI from the returned :class:`CampaignResult`."""

from .campaign import (
    ACCOUNTING_FIELDS,
    VMAP_FIELDS,
    CampaignSpec,
    CellSpec,
    Task,
    group_signature,
    run_campaign,
)
from .metrics import CampaignResult, CellResult, mean_ci
from .plan import (
    CampaignPlan,
    CompileCache,
    PlanGroup,
    default_compile_cache,
    fusable,
    fused_signature,
    plan_campaign,
)

__all__ = [
    "ACCOUNTING_FIELDS",
    "VMAP_FIELDS",
    "CampaignSpec",
    "CellSpec",
    "Task",
    "group_signature",
    "run_campaign",
    "CampaignResult",
    "CellResult",
    "mean_ci",
    "CampaignPlan",
    "PlanGroup",
    "CompileCache",
    "default_compile_cache",
    "fusable",
    "fused_signature",
    "plan_campaign",
]
