"""Service plane: the resident, checkpointed, double-buffered serving loop.

Counterpart of the JAX package's ``service/`` loop and request sources:
``run_until_device`` windows, exact checkpoint and resume
(``checkpoint.py``) and socket serving (``gateway.py``) composed into a
long-running process (service/loop.py, service/ingest.py).  ``python -m
oversim_tpu_torch.service --help`` runs one from flags.  The daemon tier
(``mux``, ``tenant``, ``daemon``) is still to be ported (ROADMAP Queue
A).
"""

from oversim_tpu_torch.service.ingest import (  # noqa: F401
    GatewayIngest,
    InProcessIngest,
)
from oversim_tpu_torch.service.loop import (  # noqa: F401
    ServiceLoop,
    ServiceParams,
    campaign_summarize_leaves,
    counter_leaf_refs,
    summarize_counter_leaves,
)
