"""Campaign runner: S replicas of one scenario, seed and parameter sweeps.

See ``oversim_tpu_torch/campaign/runner.py``; ``python -m
oversim_tpu_torch.campaign --help`` runs one from flags.
"""

from oversim_tpu_torch.campaign.runner import (  # noqa: F401
    Campaign,
    CampaignParams,
    expand_grid,
)
